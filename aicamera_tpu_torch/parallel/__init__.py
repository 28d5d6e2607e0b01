"""Many independent video streams through one device step.

The port of ``aicamera_tpu/parallel``: :class:`MultiStreamPipeline` batches
the detection work of S streams into one forward and runs each stream's
tracker on its own state. The device meshes (``make_mesh``,
``make_stream_mesh``) and the tensor- and pipeline-parallel modules are not
ported.
"""

from .multistream import MultiStreamPipeline, make_mesh, make_stream_mesh

__all__ = ["MultiStreamPipeline", "make_mesh", "make_stream_mesh"]
