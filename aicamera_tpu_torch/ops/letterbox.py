"""The letterbox kernel (``csrc/letterbox.cu``) and its wrapper.

:func:`letterbox` turns a chunk of uint8 BGR frames ``(K, H, W, 3)`` into the
detector's input ``(K, 3, Dh, Dw)`` (RGB, [0, 1], f32 or bf16). On a CUDA
tensor it launches the hand-written Hopper kernel, one launch per chunk, on
the current stream, and counts the launch in ``KERNEL.launches``; on a CPU
tensor it runs the plain PyTorch version :func:`letterbox_plain` (same
module family: ``ops/preprocess.py``), which has the kernel's arithmetic
order and is its oracle on the card. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

Replaces ``aicamera_tpu/ops/pallas_preprocess.py::_kernel``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import cuda_build
from .preprocess import LetterboxSpec, letterbox_plain, letterbox_taps

__all__ = ["KERNEL", "letterbox", "letterbox_plain"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)


class LetterboxKernel:
    """Builds, loads and launches ``csrc/letterbox.cu``; counts launches."""

    name = "letterbox"
    source = cuda_build.CSRC_DIR / "letterbox.cu"
    replaces = "aicamera_tpu/ops/pallas_preprocess.py:132"

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()
        self._taps = {}

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source)
                fn = lib.aicam_letterbox_u8
                fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def _device_taps(self, spec: LetterboxSpec, device: torch.device):
        key = (spec, device)
        if key not in self._taps:
            ty, tx, resize = letterbox_taps(spec)
            idx = np.concatenate([ty[0], ty[1], tx[0], tx[1]])
            wts = np.concatenate([ty[2], ty[3], tx[2], tx[3]])
            self._taps[key] = (torch.from_numpy(idx).to(device),
                               torch.from_numpy(wts).to(device), resize)
        return self._taps[key]

    def __call__(self, frames: torch.Tensor, spec: LetterboxSpec,
                 out_dtype: torch.dtype) -> torch.Tensor:
        check_args(frames, spec, out_dtype)
        if frames.device.type != "cuda":
            raise ValueError(f"the letterbox kernel needs a CUDA tensor "
                             f"(got {frames.device})")
        fn = self.load().aicam_letterbox_u8
        k, h, w, _ = frames.shape
        dh, dw = spec.out_hw
        uh, uw = spec.unpad_hw
        with torch.cuda.device(frames.device):
            taps_i, taps_w, resize = self._device_taps(spec, frames.device)
            out = torch.empty((k, 3, dh, dw), dtype=out_dtype,
                              device=frames.device)
            stream = torch.cuda.current_stream(frames.device).cuda_stream
            err = fn(frames.data_ptr(), out.data_ptr(), taps_i.data_ptr(),
                     taps_w.data_ptr(), k, h, w, dh, dw, uh, uw, spec.top,
                     spec.left, int(resize), int(out_dtype == torch.bfloat16),
                     stream)
        if err != 0:
            raise RuntimeError(f"letterbox kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return out


def check_args(frames: torch.Tensor, spec: LetterboxSpec,
               out_dtype: torch.dtype) -> None:
    """The argument checks the kernel relies on (device-independent)."""
    if frames.dtype != torch.uint8:
        raise TypeError(f"frames must be uint8 (got {frames.dtype})")
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (K, H, W, 3) (got "
                         f"{tuple(frames.shape)})")
    if tuple(frames.shape[1:3]) != tuple(spec.src_hw):
        raise ValueError(f"frame size {tuple(frames.shape[1:3])} does not "
                         f"match the letterbox spec {spec.src_hw}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16 (got "
                        f"{out_dtype})")


KERNEL = LetterboxKernel()


def letterbox(frames: torch.Tensor, spec: LetterboxSpec,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR ``(K, H, W, 3)`` -> letterboxed RGB ``(K, 3, Dh, Dw)``.

    CUDA tensor: the kernel. CPU tensor: the plain version. Anything else
    raises."""
    check_args(frames, spec, out_dtype)
    if frames.device.type == "cpu":
        return letterbox_plain(frames, spec, out_dtype)
    return KERNEL(frames, spec, out_dtype)
