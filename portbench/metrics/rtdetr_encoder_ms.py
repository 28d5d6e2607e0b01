"""Device milliseconds a dispatch in RT-DETR's ``encoder`` stage: the
program's stamps inside the captured step (``CudaStageTimer``, on in
``--trace 1`` runs of a ``multistream_stages`` cell), the mean over
every dispatch of the window read back. None where the step has no such
stamp."""


def read(ctx):
    return (ctx.counters.get("stage_ms") or {}).get("encoder") or None
