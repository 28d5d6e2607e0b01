"""Tracker-state checkpoint and resume.

The port of ``aicamera_tpu/runtime/checkpoint.py``. The whole tracker state
(Kalman bank, galleries or appearance banks, lifecycle counters, id counter)
goes into one file, so that a long-running stream survives a restart with its
track identities. The file format is the JAX package's: the Flax msgpack of
the state's field dict (``runtime/params.py`` holds the reader and the
writer), so a checkpoint written by either package loads in the other; the
stacked states of several streams are the same dict with a leading stream
axis on every field.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from ..core import bytetrack as _bt
from ..core import ocsort as _oc
from ..core.state import init_state
from ..device import resolve_device
from .params import load_flax_msgpack, write_flax_msgpack


def save_state(path: str | Path, state) -> None:
    """Write a tracker state (DeepSORT, ByteTrack or OC-SORT; one stream's,
    or the stacked states of several, ``MultiStreamPipeline.states``) to
    ``path``.

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
               device=None):
    """Load a tracker state onto ``device`` (default the GPU; raises without
    one, pass ``"cpu"`` there); shapes and dtypes must match the given
    params.

    ``params`` selects the state family: ``TrackerParams`` loads a DeepSORT
    ``TrackerState``, ``ByteTrackParams`` a ``ByteTrackState``,
    ``OCSortParams`` an ``OCSortState``. ``n_streams=S`` loads S stacked
    states: every field with a leading stream axis of S, as
    ``MultiStreamPipeline.states`` holds them."""
    device = resolve_device(device)
    # the template only gives shapes and dtypes; state_like moves the fields
    if isinstance(params, _bt.ByteTrackParams):
        template = _bt.init_state(params, "cpu")
    elif isinstance(params, _oc.OCSortParams):
        template = _oc.init_state(params, "cpu")
    else:
        template = init_state(params, "cpu")
    tree = load_flax_msgpack(path)
    names = [f.name for f in dataclasses.fields(template)]
    if not isinstance(tree, dict) or set(tree) != set(names):
        raise ValueError(
            f"{path} does not hold a {type(template).__name__}: fields "
            f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
    fields = {name: None if tree[name] is None
              else torch.from_numpy(np.array(tree[name]))  # a writable copy
              for name in names}
    lead = () if n_streams is None else (int(n_streams),)
    return state_like(template, fields, lead, device, where=str(path))


def state_like(template, fields: dict, lead: tuple, device, where: str):
    """``fields`` (name -> tensor or None) as a state of ``template``'s
    family on ``device``, each tensor checked against the template's shape
    (after the leading axes ``lead``, e.g. ``(S,)`` for stacked streams)
    and dtype."""
    out = {}
    for f in dataclasses.fields(template):
        want, got = getattr(template, f.name), fields[f.name]
        if (want is None) != (got is None):
            raise ValueError(f"{where}: field {f.name} does not match the "
                             f"params (with_appearance differs)")
        if want is None:
            out[f.name] = None
            continue
        shape = (*lead, *want.shape)
        if tuple(got.shape) != shape or got.dtype != want.dtype:
            raise ValueError(
                f"{where}: field {f.name} is {got.dtype}{tuple(got.shape)}, "
                f"the params give {want.dtype}{shape}")
        out[f.name] = got.to(device)
    return type(template)(**out)
