"""AICamera on PyTorch and CUDA: the port of ``aicamera_tpu`` to one NVIDIA
H100.

Same layout as the JAX package (``cli``, ``config``, ``utils``, ``ops``,
``models``, ``core``, ``runtime``) plus ``csrc/`` for the hand-written CUDA
kernels. The package imports PyTorch, numpy and the standard library only,
never JAX or the JAX package. Entry points (``cli.main``,
``runtime.pipeline.TrackingPipeline``) run on the GPU unless the caller
passes ``device="cpu"`` (``--device cpu``).
"""

from . import config  # noqa: F401

__all__ = ["config", "not_ported"]


def not_ported(what: str) -> NotImplementedError:
    """The error every part of the JAX package that the port lacks raises."""
    return NotImplementedError(
        f"{what} is not ported to aicamera_tpu_torch yet (see ROADMAP.md)")
