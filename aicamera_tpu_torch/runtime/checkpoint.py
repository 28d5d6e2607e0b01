"""Tracker-state checkpoint and resume.

The port of ``aicamera_tpu/runtime/checkpoint.py``. The whole tracker state
(Kalman bank, galleries or appearance banks, lifecycle counters, id counter)
goes into one file, so that a long-running stream survives a restart with its
track identities. The file format is the JAX package's: the Flax msgpack of
the state's field dict (``runtime/params.py`` holds the reader and the
writer), so a checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from .. import not_ported
from ..core import bytetrack as _bt
from ..core import ocsort as _oc
from ..core.state import init_state
from .params import load_flax_msgpack, write_flax_msgpack


def save_state(path: str | Path, state) -> None:
    """Write a tracker state (DeepSORT, ByteTrack or OC-SORT) to ``path``.

    The write is atomic (a temporary file beside the target, then a rename),
    so a periodic snapshot never leaves a torn file behind if the process
    dies mid-write; the previous file stays whole until the rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tree = {f.name: None if getattr(state, f.name) is None
            else getattr(state, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(state)}
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(write_flax_msgpack(tree))
    tmp.replace(path)


def load_state(path: str | Path, params, n_streams: int | None = None,
               device="cpu"):
    """Load a tracker state onto ``device``; shapes and dtypes must match
    the given params.

    ``params`` selects the state family: ``TrackerParams`` loads a DeepSORT
    ``TrackerState``, ``ByteTrackParams`` a ``ByteTrackState``,
    ``OCSortParams`` an ``OCSortState``. ``n_streams`` (stacked per-stream
    states) is not ported."""
    if n_streams is not None:
        raise not_ported("multi-stream tracker state (n_streams)")
    if isinstance(params, _bt.ByteTrackParams):
        template = _bt.init_state(params)
    elif isinstance(params, _oc.OCSortParams):
        template = _oc.init_state(params)
    else:
        template = init_state(params)
    tree = load_flax_msgpack(path)
    names = [f.name for f in dataclasses.fields(template)]
    if not isinstance(tree, dict) or set(tree) != set(names):
        raise ValueError(
            f"{path} does not hold a {type(template).__name__}: fields "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
    fields = {}
    for name in names:
        want, got = getattr(template, name), tree[name]
        if (want is None) != (got is None):
            raise ValueError(f"{path}: field {name} does not match the "
                             f"params (with_appearance differs)")
        if want is None:
            fields[name] = None
            continue
        got = torch.from_numpy(np.array(got))  # a writable copy
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(
                f"{path}: field {name} is {got.dtype}{tuple(got.shape)}, "
                f"the params give {want.dtype}{tuple(want.shape)}")
        fields[name] = got.to(device)
    return type(template)(**fields)
