"""Faults planted in the program underneath a run, to see ``correct`` come
out false: the tracker step returning its state unchanged, every other
frame's detections left out of the batch, the emitted tracks' boxes moved
by a box width where they are produced, and their ids renumbered on every
other frame of a track's life.

Each is a context manager that patches the program's module attributes and
restores them on exit (``portbench/control.py --control fault_<name>`` on
the chip; ``portbench/tests`` on the CPU).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(pairs):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in pairs]
    try:
        for mod, name, value in pairs:
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def state_unchanged():
    import aicamera_tpu_torch.core.bytetrack as bt_core
    import aicamera_tpu_torch.core.tracker as ds_core
    return _patched([(ds_core, "update", lambda state, dets, p: state),
                     (bt_core, "step",
                      lambda state, dets, p, gmc=None: state)])


def half_the_batch_left_out():
    import aicamera_tpu_torch.runtime.pipeline as pipeline_mod
    real = pipeline_mod.fused_decode_nms

    def half(*a, **kw):
        num, boxes, scores, labels = real(*a, **kw)
        num = num.clone()
        num[1::2] = 0
        return num, boxes, scores, labels

    return _patched([(pipeline_mod, "fused_decode_nms", half)])


def answers_altered():
    import aicamera_tpu_torch.core.bytetrack as bt_core
    import aicamera_tpu_torch.core.tracker as ds_core
    pairs = []
    for mod in (ds_core, bt_core):
        def shifted(st, *a, _real=mod.get_outputs):
            tlbr, ids, cls, conf, mask = _real(st, *a)
            w = (tlbr[..., 2] - tlbr[..., 0])[..., None]
            z = torch.zeros_like(w)
            return tlbr + torch.cat([w, z, w, z], -1), ids, cls, conf, mask
        pairs.append((mod, "get_outputs", shifted))
    return _patched(pairs)


def ids_renumbered():
    """Each emitted track shows another id on every other frame: the boxes,
    classes and scores stay right, the identities do not. The alternation
    comes from the state on the device (a DeepSORT track's age, ByteTrack's
    frame counter), so a captured step carries it too."""
    import aicamera_tpu_torch.core.bytetrack as bt_core
    import aicamera_tpu_torch.core.tracker as ds_core

    def renumbered(real, parity):
        def outputs(st, *a):
            tlbr, ids, cls, conf, mask = real(st, *a)
            return tlbr, ids + parity(st) * (1 << 20), cls, conf, mask
        return outputs

    return _patched([
        (ds_core, "get_outputs",
         renumbered(ds_core.get_outputs, lambda st: st.age % 2)),
        (bt_core, "get_outputs",
         renumbered(bt_core.get_outputs,
                    lambda st: (st.frame_id % 2)[..., None]))])


FAULTS = {"state_unchanged": state_unchanged,
          "half_the_batch_left_out": half_the_batch_left_out,
          "answers_altered": answers_altered,
          "ids_renumbered": ids_renumbered}
