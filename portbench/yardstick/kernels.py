"""The chip's published peaks, the program's hand kernels by the names the
profiler prints, and the bytes a letterbox launch must move.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (989 TFLOP/s bf16, 3.35
TB/s HBM3) at the 700 W limit; a card set below that reads low against
them, so the run prints the card's power limit beside any share of them.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

#: kernel -> substrings of its device functions' names
HAND_KERNELS = {
    "letterbox": ("letterbox_pixel_kernel", "letterbox_tile_kernel"),
    "nms": ("emit_kernel", "mask_kernel", "scan_kernel"),
    "assignment": ("assignment_kernel",),
    "oru": ("oru_kernel",),
    "branch": ("set_branch",),
}


def kernel_of(name: str) -> str | None:
    for kernel, parts in HAND_KERNELS.items():
        if any(p in name for p in parts):
            return kernel
    return None


def letterbox_bytes(src_hw, dst_hw, frames: int, out_bytes: int = 2) -> int:
    """Bytes one letterbox launch over ``frames`` frames must move: every
    source row that some output row taps with a weight above 0, read once
    (``W * 3`` bytes), and the ``(3, Dh, Dw)`` output written once in
    ``out_bytes`` a value (bf16: 2)."""
    from ..reference.letterbox import Letterbox
    lb = Letterbox(src_hw, dst_hw, "cpu")
    if lb.resize:
        y0, y1, w0, w1 = (t.numpy() for t in lb.ty)
        rows = len(np.union1d(y0[w0 != 0], y1[w1 != 0]))
    else:
        rows = src_hw[0]
    return frames * (rows * src_hw[1] * 3
                     + 3 * dst_hw[0] * dst_hw[1] * out_bytes)
