"""The letterbox kernel (``csrc/letterbox.cu``) and its wrapper.

:func:`letterbox` turns a chunk of uint8 BGR frames ``(K, H, W, 3)`` into the
detector's input ``(K, 3, Dh, Dw)`` (RGB, [0, 1], f32 or bf16). On a CUDA
tensor it launches the hand-written Hopper kernel, one launch per chunk, on
the current stream, and counts the launch in ``KERNEL.launches``; on a CPU
tensor it runs the plain PyTorch version :func:`letterbox_plain` (same
module family: ``ops/preprocess.py``), which has the kernel's arithmetic
order and is its oracle on the card. There is no fallback from one to the
other: a CUDA tensor launches a kernel or raises.

The source holds two kernels. :func:`launch_plan`, a pure function of the
shapes and the alignment, picks one: the vector variant (a block per tile of
output rows, source rows staged in shared memory, 16-byte accesses) where
its alignment rules hold, else the scalar variant (one thread per output
pixel), which takes every geometry.

Replaces ``aicamera_tpu/ops/pallas_preprocess.py::_kernel``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Tuple

import numpy as np
import torch

from . import cuda_build
from .preprocess import LetterboxSpec, letterbox_plain, letterbox_taps

__all__ = ["KERNEL", "LaunchPlan", "launch_plan", "letterbox",
           "letterbox_plain", "traffic"]

_OUT_DTYPES = (torch.float32, torch.bfloat16)

GROUP = 8                  # output pixels per thread, vector variant
SMEM_LIMIT = 232448        # 227 KB: the most shared memory a block can use
TILE_ROWS = (2, 1)         # output rows per block: the candidates
BLOCK_THREADS = 80         # aimed-at threads per block, vector variant
MAX_GROUPS = 320           # threads along a row (the kernel's launch bound)
PIXEL_THREADS = 256        # threads per block, scalar variant


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Which kernel runs and how: ``variant`` is ``"vector"`` or
    ``"scalar"``; ``rows`` is the output rows per block (vector only)."""
    variant: str
    grid: Tuple[int, ...]
    block: Tuple[int, ...]
    rows: int = 0
    smem_bytes: int = 0
    reason: str = ""         # why the scalar variant was taken


def row_taps(spec: LetterboxSpec):
    """The vector variant's row taps ``(y0, y1, wy0, wy1)`` over the content
    rows: those of :func:`letterbox_taps`, with a tap of weight 0 moved onto
    its partner. A weight-0 tap adds ``byte * 0 == +0`` to the blend whatever
    row it names, so the output keeps its bits, and a tile's band then holds
    only source rows that contribute: at an integer ratio (1920x1080 to
    640x360) one row per output row, not two."""
    (y0, y1, wy0, wy1), _, _ = letterbox_taps(spec)
    y1 = np.where(wy1 == 0, y0, y1)
    y0 = np.where(wy0 == 0, y1, y0)
    return y0, y1, wy0, wy1


def band_rows(spec: LetterboxSpec, rows: int) -> int:
    """The most source rows any tile of ``rows`` output rows stages: from
    the upper tap of its first content row to the lower tap of its last."""
    y0, y1, _, _ = row_taps(spec)
    top, uh = spec.top, spec.unpad_hw[0]
    most = 0
    for base in range(0, spec.out_hw[0], rows):
        lo = max(base, top) - top
        hi = min(base + rows, spec.out_hw[0], top + uh) - top  # exclusive
        if lo < hi:
            most = max(most, int(y1[hi - 1]) - int(y0[lo]) + 1)
    return most


def launch_plan(spec: LetterboxSpec, k: int, out_dtype: torch.dtype,
                frames_aligned: bool = True,
                variant: str | None = None) -> LaunchPlan:
    """Pick the kernel variant and its launch shape for ``k`` frames.

    The vector variant needs every source row and the frame pointer to start
    on a 16-byte boundary (``W * 3 % 16 == 0``, ``frames_aligned``), a
    source row of at most 65535 bytes (its tap offsets are 16-bit), every
    output row to split into whole 8-pixel groups (``Dw % 8 == 0``), at most
    ``MAX_GROUPS`` groups per row, at most 65535 frames (``gridDim.y``) and
    a band of source rows within ``SMEM_LIMIT``. Of ``TILE_ROWS`` it takes
    the tile height that stages the fewest source rows per output row (the
    taller one on a tie): small tiles in small blocks measured fastest on
    the H100, many blocks per SM overlapping one block's loads with
    another's arithmetic. Everything else, a band too large for shared
    memory included, runs the scalar variant.
    ``variant`` overrides the choice, for measurements and tests:
    ``"scalar"`` always holds, ``"vector"`` raises where its rules do
    not."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16 (got "
                        f"{out_dtype})")
    w3 = spec.src_hw[1] * 3
    dh, dw = spec.out_hw

    def scalar(reason):
        if variant == "vector":
            raise ValueError(f"the vector variant does not take this call: "
                             f"{reason}")
        total = k * dh * dw
        return LaunchPlan("scalar", (-(-total // PIXEL_THREADS),),
                          (PIXEL_THREADS,), reason=reason)

    if variant not in (None, "vector", "scalar"):
        raise ValueError(f"variant must be 'vector' or 'scalar' (got "
                         f"{variant!r})")
    if variant == "scalar":
        return scalar("asked for")
    if w3 % 16:
        return scalar(f"source row of {w3} bytes is not a multiple of 16")
    if w3 > 65535:
        return scalar(f"source row of {w3} bytes exceeds the 16-bit tap "
                      "offsets")
    if not frames_aligned:
        return scalar("frames do not start on a 16-byte boundary")
    if dw % GROUP:
        return scalar(f"output width {dw} is not a multiple of {GROUP}")
    groups = dw // GROUP
    if groups > MAX_GROUPS:
        return scalar(f"output width {dw} exceeds {MAX_GROUPS * GROUP}")
    if k > 65535:
        return scalar(f"{k} frames exceed the grid's 65535")
    rows = min(TILE_ROWS, key=lambda r: (band_rows(spec, r) / r, -r))
    smem = band_rows(spec, rows) * w3
    if smem > SMEM_LIMIT:
        return scalar(f"a band of {smem} bytes exceeds the {SMEM_LIMIT} "
                      "bytes of shared memory a block can use")
    block_rows = max(1, min(rows, BLOCK_THREADS // groups))
    return LaunchPlan("vector", (-(-dh // rows), k), (groups, block_rows),
                      rows=rows, smem_bytes=smem)


def pixel_tables(spec: LetterboxSpec):
    """The scalar variant's taps over the content rectangle:
    ``[y0 (uh), y1 (uh), x0 (uw), x1 (uw)]`` as int32 indices and f32
    weights; plus whether the rounding runs."""
    ty, tx, resize = letterbox_taps(spec)
    return (np.concatenate([ty[0], ty[1], tx[0], tx[1]]),
            np.concatenate([ty[2], ty[3], tx[2], tx[3]]), resize)


def tile_tables(spec: LetterboxSpec):
    """The vector variant's taps over the whole canvas, indexed by output
    row and column: ``[y0 (dh4), y1 (dh4), x0 * 3 (dw), x1 * 3 (dw)]`` as
    int32 and the weights alike as f32, ``dh4`` being ``Dh`` rounded up to a
    multiple of 4 (so the column sections start on 16 bytes). The row taps
    are those of :func:`row_taps`. A pad row has ``y0 == -1``; a pad column
    has offsets 0 and weights 0."""
    _, tx, resize = letterbox_taps(spec)
    ty = row_taps(spec)
    dh, dw = spec.out_hw
    uh, uw = spec.unpad_hw
    dh4 = -(-dh // 4) * 4
    tab_i = np.zeros(2 * dh4 + 2 * dw, np.int32)
    tab_w = np.zeros(2 * dh4 + 2 * dw, np.float32)
    tab_i[:dh4] = -1
    for sec, (ti, tw) in enumerate(((ty[0], ty[2]), (ty[1], ty[3]))):
        a = sec * dh4 + spec.top
        tab_i[a:a + uh], tab_w[a:a + uh] = ti, tw
    for sec, (ti, tw) in enumerate(((tx[0], tx[2]), (tx[1], tx[3]))):
        a = 2 * dh4 + sec * dw + spec.left
        tab_i[a:a + uw], tab_w[a:a + uw] = ti * 3, tw
    return tab_i, tab_w, resize


def _current_stream(device: torch.device) -> int:
    """The current CUDA stream's handle. PyTorch's raw getter where this
    build has it; the public call builds a ``Stream`` object first, which
    costs about a third of the wrapper's whole host time per call."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device() if device.index is None
                   else device.index)
    return torch.cuda.current_stream(device).cuda_stream


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """One cached launch: the bound C function, the plan, the tap tables on
    the device (kept alive: the arguments point into them), the arguments
    that do not change from call to call, and the output shape."""
    fn: object
    plan: LaunchPlan
    tables: tuple
    args: tuple
    out_shape: tuple


class LetterboxKernel:
    """Builds, loads and launches ``csrc/letterbox.cu``; counts launches."""

    name = "letterbox"
    source = cuda_build.CSRC_DIR / "letterbox.cu"
    replaces = "aicamera_tpu/ops/pallas_preprocess.py:132"

    def __init__(self):
        self.launches = 0
        self.last_plan: LaunchPlan | None = None  # of the latest launch
        self._lib = None
        self._lock = threading.Lock()
        self._prepared = {}

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = cuda_build.load_library(self.source)
                for fn, n_int in ((lib.aicam_letterbox_pixel, 11),
                                  (lib.aicam_letterbox_tile, 14)):
                    fn.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * n_int
                                   + [ctypes.c_void_p])
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def _prepare(self, key) -> _Prepared:
        spec, k, out_dtype, device, aligned, variant = key
        plan = launch_plan(spec, k, out_dtype, frames_aligned=aligned,
                           variant=variant)
        lib = self.load()
        h, w = spec.src_hw
        dh, dw = spec.out_hw
        uh, uw = spec.unpad_hw
        if plan.variant == "vector":
            fn, (tab_i, tab_w, resize) = (lib.aicam_letterbox_tile,
                                          tile_tables(spec))
            tail = (plan.rows, plan.block[1], plan.smem_bytes)
        else:
            fn, (tab_i, tab_w, resize) = (lib.aicam_letterbox_pixel,
                                          pixel_tables(spec))
            tail = ()
        tables = (torch.from_numpy(tab_i).to(device),
                  torch.from_numpy(tab_w).to(device))
        args = (tables[0].data_ptr(), tables[1].data_ptr(), k, h, w, dh, dw,
                uh, uw, spec.top, spec.left, int(resize),
                int(out_dtype == torch.bfloat16), *tail)
        prep = _Prepared(fn, plan, tables, args, (k, 3, dh, dw))
        self._prepared[key] = prep
        return prep

    def launch(self, frames: torch.Tensor, spec: LetterboxSpec,
               out_dtype: torch.dtype,
               variant: str | None = None) -> torch.Tensor:
        """Launch on checked arguments (see :func:`check_args`): ``frames``
        is a CUDA tensor. ``variant`` overrides the plan as in
        :func:`launch_plan`."""
        device = frames.device
        key = (spec, frames.shape[0], out_dtype, device,
               frames.data_ptr() % 16 == 0, variant)
        prep = self._prepared.get(key) or self._prepare(key)
        out = torch.empty(prep.out_shape, dtype=out_dtype, device=device)
        if device.index == torch.cuda.current_device():
            err = prep.fn(frames.data_ptr(), out.data_ptr(), *prep.args,
                          _current_stream(device))
        else:
            with torch.cuda.device(device):
                err = prep.fn(frames.data_ptr(), out.data_ptr(), *prep.args,
                              _current_stream(device))
        if err != 0:
            raise RuntimeError(f"letterbox kernel launch failed: CUDA error "
                               f"{err} ({prep.plan})")
        self.launches += 1
        self.last_plan = prep.plan
        return out

    def __call__(self, frames: torch.Tensor, spec: LetterboxSpec,
                 out_dtype: torch.dtype,
                 variant: str | None = None) -> torch.Tensor:
        check_args(frames, spec, out_dtype)
        if frames.device.type != "cuda":
            raise ValueError(f"the letterbox kernel needs a CUDA tensor "
                             f"(got {frames.device})")
        return self.launch(frames, spec, out_dtype, variant)


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


def traffic(spec: LetterboxSpec, k: int, out_dtype: torch.dtype):
    """The bytes a letterbox of ``k`` frames must move, the count that its
    bound (``chip_smoke.py``) and ``runtime.profiler.device_cost`` read:
    ``(in_bytes, out_bytes, rows_read)``. The input is the source rows that
    some output row taps with a weight above 0, whole (``W * 3`` bytes
    each), read once (at 1920x1080 to 640x360 every third row, at 960x540
    every row); the output is written once."""
    (y0, y1, wy0, wy1), _, _ = letterbox_taps(spec)
    rows_read = len(np.union1d(y0[wy0 != 0], y1[wy1 != 0]))
    in_bytes = k * rows_read * spec.src_hw[1] * 3
    out_bytes = (k * 3 * spec.out_hw[0] * spec.out_hw[1]
                 * torch.finfo(out_dtype).bits // 8)
    return in_bytes, out_bytes, rows_read


def _cost_mode():
    """The active ``runtime.profiler.CostMode``, if any: the dispatcher
    never sees the kernel's launch (it goes through ``ctypes``), so the
    letterbox reports its own bytes to it."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    mode = _get_current_dispatch_mode()
    return mode if hasattr(mode, "opaque") else None


def letterbox(frames: torch.Tensor, spec: LetterboxSpec,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 BGR ``(K, H, W, 3)`` -> letterboxed RGB ``(K, 3, Dh, Dw)``.

    CUDA tensor: the kernel. CPU tensor: the plain version. Anything else
    raises. Under a ``CostMode`` the call counts as the kernel's
    :func:`traffic` on either device."""
    check_args(frames, spec, out_dtype)
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"letterbox runs on CUDA or CPU tensors (got "
                         f"{frames.device})")
    mode = _cost_mode()
    if mode is None:
        return _letterbox(frames, spec, out_dtype)
    in_bytes, out_bytes, _ = traffic(spec, frames.shape[0], out_dtype)
    with mode.opaque(KERNEL.name, in_bytes + out_bytes):
        return _letterbox(frames, spec, out_dtype)


def _letterbox(frames, spec, out_dtype):
    if frames.device.type == "cpu":
        return letterbox_plain(frames, spec, out_dtype)
    return KERNEL.launch(frames, spec, out_dtype)
