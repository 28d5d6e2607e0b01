"""Counting host syncs taken by data-dependent control flow.

The JAX package keeps its loops and branches on the device
(``lax.while_loop``, ``lax.cond``); the port runs them as Python control
flow, and each data-dependent condition reads one device value back to the
host. A :class:`SyncCounter` takes those reads, so that a run can report how
many it made per frame.
"""

from __future__ import annotations

import torch


class SyncCounter:
    """Reads small values back from the device and counts the reads."""

    def __init__(self):
        self.count = 0

    def flag(self, t: torch.Tensor) -> bool:
        self.count += 1
        return bool(t)

    def tolist(self, t: torch.Tensor):
        self.count += 1
        return t.tolist()
