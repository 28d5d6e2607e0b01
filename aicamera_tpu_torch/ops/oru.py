"""The ORU replay kernel (``csrc/oru.cu``) and its wrapper.

OC-SORT's observation-centric re-update for every track slot of one stream
(``x (T, 7)``) or of a stack of streams (``x (S, T, 7)``), one launch on the
current stream, a thread a slot, nothing read back: the OC-SORT step around
it stays on the device, and a CUDA graph can capture it. Each launch adds one
to ``KERNEL.launches``.

The kernel computes what ``core.ocsort.oru_replay_plain`` computes (the CPU
path and the kernel's oracle on the card), in its operation order, to
rounding: the plain version's 7x7 products go through cuBLAS on the card.
``core.ocsort.oru_replay`` picks between the two by the tensors' device;
there is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.

Replaces the JAX package's device loop (XLA, not Pallas) in
``aicamera_tpu/core/ocsort.py``: ``step``'s ``do_replay`` and its
``lax.while_loop``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import cuda_build
from .letterbox import _current_stream

__all__ = ["KERNEL", "OruKernel", "check_args"]


def check_args(x, p, frozen_x, frozen_p, replay, gap, z1, z2) -> None:
    """The argument checks the kernel relies on (device-independent): ``x``
    and ``frozen_x`` f32 ``(..., T, 7)``, ``p`` and ``frozen_p`` f32
    ``(..., T, 7, 7)``, ``replay`` bool and ``gap`` int32 ``(..., T)``,
    ``z1`` and ``z2`` f32 ``(..., T, 4)``, all on one device."""
    lead = tuple(x.shape[:-1])
    want = {"x": (x, lead + (7,), torch.float32),
            "p": (p, lead + (7, 7), torch.float32),
            "frozen_x": (frozen_x, lead + (7,), torch.float32),
            "frozen_p": (frozen_p, lead + (7, 7), torch.float32),
            "replay": (replay, lead, torch.bool),
            "gap": (gap, lead, torch.int32),
            "z1": (z1, lead + (4,), torch.float32),
            "z2": (z2, lead + (4,), torch.float32)}
    if x.ndim < 2 or x.shape[-1] != 7:
        raise ValueError(f"x must be (..., T, 7) (got {tuple(x.shape)})")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}{shape} (got "
                             f"{t.dtype}{tuple(t.shape)})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


class OruKernel:
    """Builds, loads and launches ``csrc/oru.cu``; counts launches."""

    name = "oru"
    source = cuda_build.CSRC_DIR / "oru.cu"
    replaces = ("aicamera_tpu/core/ocsort.py:540 step's do_replay (its "
                "lax.while_loop at :581)")
    #: no fused multiply-adds: each operation rounds as the plain version's
    #: separate PyTorch kernels round it
    flags = ("--fmad=false",)

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source, flags=self.flags)
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                lib.aicam_oru_replay.argtypes = (
                    [i32] + [ptr] * 8 + [i32] + [ptr] * 3)
                lib.aicam_oru_replay.restype = i32
                self._lib = lib
            return self._lib

    def __call__(self, x, p, frozen_x, frozen_p, replay, gap, z1, z2,
                 max_gap: int):
        """``(x, p)`` after the replay of every slot (new tensors); slots
        without a replay keep their input."""
        check_args(x, p, frozen_x, frozen_p, replay, gap, z1, z2)
        if x.device.type != "cuda":
            raise ValueError(f"the ORU kernel needs CUDA tensors (got "
                             f"{x.device})")
        lib = self._lib or self.load()
        # held until the launch is enqueued
        ins = [t.contiguous() for t in (x, p, frozen_x, frozen_p, replay,
                                        gap, z1, z2)]
        x_out = torch.empty_like(ins[0])
        p_out = torch.empty_like(ins[1])
        n = x.numel() // 7
        dev = x.device
        args = (n, *(t.data_ptr() for t in ins), int(max_gap),
                x_out.data_ptr(), p_out.data_ptr())
        if dev.index == torch.cuda.current_device():
            err = lib.aicam_oru_replay(*args, _current_stream(dev))
        else:
            with torch.cuda.device(dev):
                err = lib.aicam_oru_replay(*args, _current_stream(dev))
        if err != 0:
            raise RuntimeError(f"ORU kernel launch failed: CUDA error {err} "
                               f"(x {tuple(x.shape)})")
        self.launches += 1
        return x_out, p_out


KERNEL = OruKernel()
