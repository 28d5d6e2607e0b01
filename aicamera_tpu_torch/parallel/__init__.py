"""Multi-stream and multi-device scaling over ``torch.distributed``.

The port of ``aicamera_tpu/parallel``. The JAX package's scaling axis is
stream parallelism: independent video streams, each with its own tracker
state, batched into one device step and sharded over a mesh; tracking state
is per stream, so the hot path needs no collective. Here a mesh is a
``DeviceMesh`` over a world of one process per rank (:mod:`.distributed`:
``spawn`` or, under ``torchrun``, ``init_world``), and the collectives the
JAX package leaves to GSPMD are explicit and counted
(``distributed.COLLECTIVES``):

- :class:`MultiStreamPipeline` on ``make_stream_mesh()`` or
  ``make_mesh(S, M)``: one gather of the outputs a dispatch;
- :func:`shard_detector_params`: convolutions split by output channel over
  the ``model`` axis, one all-gather a split conv;
- :class:`PipelineParallelDetector`: the detector's three stages on
  devices of one process, or on stage meshes of the world.

``train.make_train_step_dp`` is the data-parallel trainer (one all-reduce
a step).
"""

from .multistream import MultiStreamPipeline, make_mesh, make_stream_mesh
from .pipeline_parallel import PipelineParallelDetector, split_stage_params
from .tensor_parallel import replicate_params, shard_detector_params

__all__ = ["MultiStreamPipeline", "make_mesh", "make_stream_mesh",
           "PipelineParallelDetector", "split_stage_params",
           "replicate_params", "shard_detector_params"]
