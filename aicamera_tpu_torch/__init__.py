"""AICamera on PyTorch and CUDA: the port of ``aicamera_tpu`` to one NVIDIA
H100.

Same layout as the JAX package (``config``, ``ops``, ``models``, ``core``,
``runtime``) plus ``csrc/`` for the hand-written CUDA kernels. The package
imports PyTorch, numpy and the standard library only, never JAX or the JAX
package. Entry points (``runtime.pipeline.TrackingPipeline``) run on the GPU
unless the caller passes ``device="cpu"``.
"""

from . import config  # noqa: F401

__all__ = ["config"]
