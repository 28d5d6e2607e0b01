"""The ORU replay kernel (``csrc/oru.cu``) and its wrapper.

OC-SORT's observation-centric re-update for every track slot of one stream
(``x (T, 7)``) or of a stack of streams (``x (S, T, 7)``), one launch on the
current stream, nothing read back: the OC-SORT step around it stays on the
device, and a CUDA graph can capture it. Each launch adds one to
``KERNEL.launches``.

Two designs are built from the one source: ``"rows"`` (the default, every
path's: a group of 8 lanes a slot, lane r on row r of the covariance, 8
slots a block, the slots' states copied in 16-byte chunks, and only the
warps that hold a replaying slot step, converged, to their largest gap)
and ``"v1"`` (the first design, a thread a slot, kept for measurements and
tests, on no path). The two are bitwise equal: each element is the same
sequence of rounded operations in both (``csrc/oru.cu``'s header).

The kernel computes what ``core.ocsort.oru_replay_plain`` computes (the CPU
path and the kernel's oracle on the card), in its operation order. The
plain version's 7x7 products go through cuBLAS on the card, which may order
a sum otherwise, so the two are held within 1e-5 of a slot's scale; on every
lane ``chip_smoke.py`` has checked they were bitwise equal.
``core.ocsort.oru_replay`` picks between the two by the tensors' device;
there is no fallback from one to the other: a CUDA tensor launches the
kernel or raises.
``OruKernel(probe=True)`` builds a second library with the phase probe
compiled in (``-DAICAM_ORU_PROBE``); :meth:`OruKernel.read_probe` returns
its sums.

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

__all__ = ["KERNEL", "PROBE_SLOTS", "VARIANTS", "OruKernel", "check_args",
           "check_variant"]

VARIANTS = ("rows", "v1")   # the designs; the first is every path's
# the probe's sums, in the order of csrc/oru.cu's ProbeSlot: slots,
# replaying slots, virtual steps, the slots' leading threads' cycles by
# phase (a virtual step's gain, Joseph product and predict summed over the
# steps), blocks and their cycles from entry to exit, a sink
PROBE_SLOTS = ("slots", "replaying", "steps", "load", "gain", "joseph",
               "predict", "store", "blocks", "total", "sink")


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} (got "
                         f"{variant!r})")


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
    """Builds, loads and launches ``csrc/oru.cu``; counts launches.
    ``probe=True``: the build with the phase probe (measurements only)."""

    name = "oru"
    source = cuda_build.CSRC_DIR / "oru.cu"
    replaces = ("aicamera_tpu/core/ocsort.py:540 step's do_replay (its "
                "lax.while_loop at :581)")
    #: no fused multiply-adds: each operation rounds as the plain version's
    #: separate PyTorch kernels round it
    flags = ("--fmad=false",)

    def __init__(self, probe: bool = False):
        self.launches = 0
        self.probe = probe
        self.defines = ("AICAM_ORU_PROBE",) if probe else ()
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source, self.defines,
                                              self.flags)
                ptr, i32 = ctypes.c_void_p, ctypes.c_int
                for fn in (lib.aicam_oru_replay, lib.aicam_oru_replay_v1):
                    fn.argtypes = [i32] + [ptr] * 8 + [i32] + [ptr] * 3
                    fn.restype = i32
                if self.probe:
                    lib.aicam_oru_probe.argtypes = [ptr, i32]
                    lib.aicam_oru_probe.restype = i32
                self._lib = lib
            return self._lib

    def read_probe(self, reset: bool = True) -> dict:
        """The probe's sums since the last reset (``PROBE_SLOTS``: slots,
        replaying slots, virtual steps, the slots' cycles by phase, blocks
        and their cycles); synchronous. ``reset`` zeroes them."""
        if not self.probe:
            raise RuntimeError("read_probe needs OruKernel(probe=True)")
        lib = self.load()
        buf = (ctypes.c_ulonglong * len(PROBE_SLOTS))()
        got = lib.aicam_oru_probe(buf, int(reset))
        if got != len(PROBE_SLOTS):
            raise RuntimeError(f"ORU probe read failed ({got})")
        return dict(zip(PROBE_SLOTS, buf))

    def __call__(self, x, p, frozen_x, frozen_p, replay, gap, z1, z2,
                 max_gap: int, variant: str = VARIANTS[0]):
        """``(x, p)`` after the replay of every slot (new tensors); slots
        without a replay keep their input. ``variant``: the design."""
        check_args(x, p, frozen_x, frozen_p, replay, gap, z1, z2)
        check_variant(variant)
        if x.device.type != "cuda":
            raise ValueError(f"the ORU kernel needs CUDA tensors (got "
                             f"{x.device})")
        lib = self._lib or self.load()
        fn = (lib.aicam_oru_replay if variant == VARIANTS[0]
              else lib.aicam_oru_replay_v1)
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
            err = fn(*args, _current_stream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, _current_stream(dev))
        if err != 0:
            raise RuntimeError(f"ORU kernel launch failed: CUDA error {err} "
                               f"(x {tuple(x.shape)}, {variant})")
        self.launches += 1
        return x_out, p_out


KERNEL = OruKernel()
