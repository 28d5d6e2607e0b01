"""Fixed-capacity tracker state and detection containers.

The port of ``aicamera_tpu/core/state.py``: all track attributes live in
padded tensors of length ``max_tracks`` with an ``active`` mask, the feature
gallery is a per-track FIFO ring, and detections are padded to
``max_detections`` with a ``valid`` mask. The containers are dataclasses of
tensors on one device; :func:`dataclasses.replace` gives an updated copy.

Track states: Tentative=1, Confirmed=2; a deleted track is ``active=False``.

Stacked states carry a leading stream axis on every field (``(S, T, ...)``,
the counters ``(S,)``), the JAX ``MultiStreamPipeline``'s layout:
:func:`init_state` makes one with ``n_streams``, and the slice/splice
helpers below work on either layout.
"""

from __future__ import annotations

import dataclasses

import torch

TENTATIVE = 1
CONFIRMED = 2


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """Static tracker hyper-parameters.

    ``nsa`` enables the noise-scale-adaptive Kalman update (measurement
    noise scaled by ``1 - confidence``). ``ema_alpha`` in (0, 1) replaces
    the FIFO gallery by one EMA embedding per track in gallery slot 0.
    """
    max_cosine_distance: float = 0.2
    nn_budget: int = 100
    max_iou_distance: float = 0.7
    max_age: int = 70
    n_init: int = 3
    max_tracks: int = 128
    max_detections: int = 64
    feature_dim: int = 512
    ema_alpha: float = 0.0
    nsa: bool = False

    def __post_init__(self):
        if not (0.0 <= self.ema_alpha < 1.0):
            raise ValueError(
                f"ema_alpha must be in [0, 1) (got {self.ema_alpha}); "
                "0 disables the EMA bank (FIFO ring)")


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """All track slots as padded tensors. T=max_tracks, G=budget, D=dim."""
    active: torch.Tensor         # (T,) bool
    state: torch.Tensor          # (T,) int32 — TENTATIVE / CONFIRMED
    mean: torch.Tensor           # (T, 8) f32
    cov: torch.Tensor            # (T, 8, 8) f32
    hits: torch.Tensor           # (T,) int32
    age: torch.Tensor            # (T,) int32
    tsu: torch.Tensor            # (T,) int32 — time_since_update
    track_id: torch.Tensor       # (T,) int32
    class_id: torch.Tensor       # (T,) int32
    conf: torch.Tensor           # (T,) f32
    gallery: torch.Tensor        # (T, G, D) f32 — feature ring buffer
    gallery_count: torch.Tensor  # (T,) int32
    gallery_next: torch.Tensor   # (T,) int32
    next_id: torch.Tensor        # () int32
    dropped: torch.Tensor        # () int32 — detections dropped to capacity

    def replace(self, **changes) -> "TrackerState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class Detections:
    """Padded per-frame detections (already class/confidence filtered)."""
    tlwh: torch.Tensor           # (N, 4) f32
    conf: torch.Tensor           # (N,) f32
    class_id: torch.Tensor       # (N,) int32
    feature: torch.Tensor        # (N, D) f32 — zeros where has_feature False
    has_feature: torch.Tensor    # (N,) bool
    valid: torch.Tensor          # (N,) bool


def init_state(params: TrackerParams, device="cpu",
               n_streams: int | None = None) -> TrackerState:
    """Fresh tracker state; track ids restart at 1. ``n_streams``: a stack
    of that many fresh states on a leading stream axis."""
    t, g, d = params.max_tracks, params.nn_budget, params.feature_dim
    lead = () if n_streams is None else (int(n_streams),)

    def z(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    return TrackerState(
        active=z((t,), torch.bool),
        state=z((t,), torch.int32),
        mean=z((t, 8), torch.float32),
        cov=z((t, 8, 8), torch.float32),
        hits=z((t,), torch.int32),
        age=z((t,), torch.int32),
        tsu=z((t,), torch.int32),
        track_id=z((t,), torch.int32),
        class_id=z((t,), torch.int32),
        conf=z((t,), torch.float32),
        gallery=z((t, g, d), torch.float32),
        gallery_count=z((t,), torch.int32),
        gallery_next=z((t,), torch.int32),
        next_id=torch.ones(lead, dtype=torch.int32, device=device),
        dropped=z((), torch.int32),
    )


def pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` zero-padded along its leading axis to ``n`` rows."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


def make_detections(tlwh, conf, class_id, feature=None, has_feature=None,
                    valid=None, *, params: TrackerParams,
                    device="cpu") -> Detections:
    """Pad raw detection arrays (numpy or tensors, leading dim
    n <= max_detections) to the static capacity."""
    n = params.max_detections
    d = params.feature_dim

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    tlwh = t(tlwh, torch.float32).reshape(-1, 4)
    k = tlwh.shape[0]
    if k > n:
        raise ValueError(f"{k} detections exceed capacity {n}")
    conf = t(conf, torch.float32).reshape(-1)
    class_id = t(class_id, torch.int32).reshape(-1)
    if feature is None:
        feature = torch.zeros((k, d), dtype=torch.float32, device=device)
        has_feature = torch.zeros((k,), dtype=torch.bool, device=device)
    else:
        feature = t(feature, torch.float32).reshape(k, d)
        has_feature = (torch.ones((k,), dtype=torch.bool, device=device)
                       if has_feature is None
                       else t(has_feature, torch.bool).reshape(-1))
    valid = (torch.ones((k,), dtype=torch.bool, device=device)
             if valid is None else t(valid, torch.bool).reshape(-1))
    # A non-finite box would poison the cost matrices; drop it here.
    valid = valid & torch.isfinite(tlwh).all(-1)

    return Detections(tlwh=pad_rows(tlwh, n), conf=pad_rows(conf, n),
                      class_id=pad_rows(class_id, n),
                      feature=pad_rows(feature, n),
                      has_feature=pad_rows(has_feature, n),
                      valid=pad_rows(valid, n))


# --- slice/splice over any tracker-state family ------------------------------
# The three cores (DeepSORT TrackerState, ByteTrackState, OCSortState) share
# what the capacity-bucketed scan needs: every non-scalar field leads with the
# track axis (after the stream axis of a stacked state), new tracks take the
# lowest free slots, overflow shows up as a ``dropped`` increment, and
# get_outputs emits zeros on masked lanes. The scalar counters travel with
# whichever state is live. The track axis is the last axis of ``active``, so
# the same helpers serve one stream and a stack (the JAX package's
# ``slice_stream_tracks`` / ``splice_stream_tracks``).

_SCALAR_STATE_FIELDS = frozenset(
    {"next_id", "dropped", "frame_count", "frame_id"})


def track_axis_field_names(state) -> tuple:
    """Names of the per-track tensor fields of any tracker-state dataclass.
    Optional fields holding ``None`` (the appearance bank of a motion-only
    ByteTrack or OC-SORT state) are skipped."""
    return tuple(f.name for f in dataclasses.fields(state)
                 if f.name not in _SCALAR_STATE_FIELDS
                 and getattr(state, f.name) is not None)


def slice_any_tracks(state, t_small: int):
    """The first ``t_small`` track slots of any core's state, one stream's
    or a stack's (views of the master's tensors; the cores never write into
    their input state)."""
    ax = state.active.ndim - 1
    return dataclasses.replace(
        state, **{f: getattr(state, f).narrow(ax, 0, t_small)
                  for f in track_axis_field_names(state)})


def splice_any_tracks(master, small):
    """A copy of ``master`` with ``small`` written into its first slots and
    ``small``'s scalar counters; ``master`` itself is left as it was."""
    ax = small.active.ndim - 1
    t_small = small.active.shape[ax]
    upd = {}
    for f in track_axis_field_names(master):
        out = getattr(master, f).clone()
        out.narrow(ax, 0, t_small).copy_(getattr(small, f))
        upd[f] = out
    for f in _SCALAR_STATE_FIELDS:
        if hasattr(master, f):
            upd[f] = getattr(small, f)
    return dataclasses.replace(master, **upd)
