"""AICamera on PyTorch and CUDA: the port of ``aicamera_tpu`` to one NVIDIA
H100.

Same layout as the JAX package (``cli``, ``config``, ``utils``, ``ops``,
``models``, ``core``, ``runtime``, ``parallel``, ``serving``, ``server``)
plus ``csrc/`` for the hand-written CUDA kernels. The package imports
PyTorch, numpy and the standard library only, never JAX or the JAX package.
Entry points (``cli.main``, ``runtime.pipeline.TrackingPipeline``,
``parallel.MultiStreamPipeline``, ``serving.TrackingService`` and
``MultiTenantTrackingService``, ``server.main`` and
``TrackingHTTPServer``, ``runtime.checkpoint.load_state``, the
reference-API facades ``YOLODetector``, ``ReIDModel``, ``DeepSORT``,
``StrongSORT``, ``ByteTrack``, ``BoTSORT``, ``OCSort`` and ``DeepOCSort``,
the trainers ``train.train_detector``, ``train_reid`` and
``finetune_on_clip`` and ``train_synthetic.main``, the world launcher
``parallel.distributed.spawn`` and ``init_world``) run on the GPU unless
the caller passes ``device="cpu"`` (``--device cpu``).
"""

from . import config  # noqa: F401

# Lazy top-level exports (PEP 562): the reference-compatible facades, the
# pipelines and the engines (the JAX package's XLAEngine is the port's
# CUDAGraphEngine), without importing PyTorch at package import time.
_LAZY_EXPORTS = {
    "YOLODetector": "aicamera_tpu_torch.detector",
    "DeepSORT": "aicamera_tpu_torch.tracker_api",
    "ReIDModel": "aicamera_tpu_torch.tracker_api",
    "ByteTrack": "aicamera_tpu_torch.bytetrack_api",
    "BoTSORT": "aicamera_tpu_torch.botsort_api",
    "StrongSORT": "aicamera_tpu_torch.strongsort_api",
    "OCSort": "aicamera_tpu_torch.ocsort_api",
    "DeepOCSort": "aicamera_tpu_torch.deepocsort_api",
    "TrackingPipeline": "aicamera_tpu_torch.runtime.pipeline",
    "MultiStreamPipeline": "aicamera_tpu_torch.parallel",
    "CUDAGraphEngine": "aicamera_tpu_torch.runtime.engine",
    "SerializedEngine": "aicamera_tpu_torch.runtime.engine",
    "load_engine": "aicamera_tpu_torch.runtime.engine",
    "export_engine": "aicamera_tpu_torch.runtime.engine",
}

__all__ = ["config", "not_ported", *sorted(_LAZY_EXPORTS)]


def __getattr__(name):
    target = _LAZY_EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(target), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY_EXPORTS))


def not_ported(what: str) -> NotImplementedError:
    """The error every part of the JAX package that the port lacks raises."""
    return NotImplementedError(
        f"{what} is not ported to aicamera_tpu_torch yet (see ROADMAP.md)")
