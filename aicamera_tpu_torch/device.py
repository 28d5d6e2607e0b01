"""The port's device rule: entry points run on the GPU unless told otherwise.

Every public entry point that takes a ``device`` argument (the pipeline, the
weight loaders) resolves it here, so that leaving it out means the GPU
everywhere and never a silent CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain CPU path")
    return dev
