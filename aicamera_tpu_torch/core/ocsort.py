"""OC-SORT: observation-centric motion tracking.

The port of ``aicamera_tpu/core/ocsort.py`` (Cao et al., CVPR 2023,
arXiv:2203.14360), fixed shape like :mod:`.tracker` and :mod:`.bytetrack`:

- **SORT Kalman filter.** 7-d state (cx, cy, s=area, r=aspect, vcx, vcy,
  vs) with the SORT noise model, Joseph-form updates and the area-collapse
  guard (vs zeroed when s + vs <= 0).
- **OCM (observation-centric momentum).** The first association maximizes
  IoU plus a velocity-direction-consistency bonus, scaled by ``inertia`` and
  the detection score.
- **OCR (observation-centric recovery).** Leftover tracks and detections
  re-associate by IoU against each track's last observation box.
- **ORU (observation-centric re-update).** A track re-observed after ``g``
  missed frames rolls back to the state frozen at its first miss and replays
  ``g`` virtual steps along the line between the last and the current
  observation.
- **Observation-centric outputs.** Emitted boxes are the matched detection;
  emission needs ``hit_streak >= min_hits`` (except during the first
  ``min_hits`` frames).
- **Deep OC-SORT** (``OCSortParams(with_appearance=True)``, Maggiolino et
  al., ICIP 2023): one EMA embedding per track, fused into round 1 as ``iou
  + ocm_bonus + aw_weight * cosine_sim`` with the adaptive weighting, and
  updated with the confidence-modulated alpha.

Semantics follow the official ``OCSort.update`` loop as the JAX module
restates it (the exact-adjacency shortcut, the strict ``score > det_thresh``
gate, the double application of the real measurement after a replay).

The step reads nothing back from its device. Where the JAX module skips a
stage with a ``lax.cond`` (the prediction of no active track, round 1 and
its exact-adjacency shortcut, round 2, the replay, the measurement update,
the births), the port computes the stage on the masks it already has and
selects with ``torch.where``: what ``jax.vmap`` of the JAX step computes.
The solve always runs and is selected against the shortcut; round 2 is
selected on the official guard. The replay's ``lax.while_loop`` is
:func:`oru_replay`: the hand-written kernel ``csrc/oru.cu`` on CUDA tensors
(``ops/oru.py``), :func:`oru_replay_plain` on CPU tensors. One code path
serves the CPU and the GPU, and a chunk's steps can be captured in one CUDA
graph (``runtime/pipeline.py``). The 4x4 gain solve is the closed-form
Cholesky of :mod:`.kalman` (S is symmetric positive definite) where the
JAX module calls an LU solve; they agree to 1e-5 relative.

Every function also takes states and detections with leading stream axes
(``OCSortState`` fields ``(S, T, ...)``, the counters ``(S,)``;
``OCSortDetections`` fields ``(S, N, ...)``): the counterpart of
``jax.vmap`` of the JAX step over streams. A round's assignment problems of
all streams go to the kernel as one batch, and the replay of every slot of
every stream is one launch. One stream is the call without the axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..ops import oru as _oru_kernel
from ..ops.gmc import warp_ocsort_state
from . import kalman
from .assignment import (_claim, _scatter_drop, _take, min_cost_matching,
                         place_new_tracks)
from .costs import iou_matrix
from .state import pad_rows

# --- SORT Kalman filter (7-dim: cx, cy, s, r, vcx, vcy, vs) ------------------

_Q_DIAG = (1, 1, 1, 1, 0.01, 0.01, 0.0001)
_R_DIAG = (1, 1, 10, 10)
_P0_DIAG = (10, 10, 10, 10, 1e4, 1e4, 1e4)


_CONSTS: dict = {}


def _const(name: str, device, make) -> torch.Tensor:
    """A constant tensor of the filter on ``device``, made once by ``make``
    from fills (a copy from host memory waits for the device's stream, and
    a CUDA graph cannot capture it). Not kept when made inside a capture
    (its memory is the graph's)."""
    device = torch.device(device)
    key = (name, device.type, device.index)
    c = _CONSTS.get(key)
    if c is None:
        c = make(device)
        if device.type != "cuda" or \
                not torch.cuda.is_current_stream_capturing():
            _CONSTS[key] = c
    return c


def _vec(values, device) -> torch.Tensor:
    """``values`` as an f32 vector, each entry a fill (rounded to f32 as
    ``torch.tensor`` rounds it)."""
    v = torch.empty(len(values), dtype=torch.float32, device=device)
    for i, x in enumerate(values):
        v[i].fill_(x)
    return v


def _diag(values, device) -> torch.Tensor:
    return _const(f"diag{values}", device,
                  lambda d: torch.diag(_vec(values, d)))


def _r_vec(device) -> torch.Tensor:
    return _const("r", device, lambda d: _vec(_R_DIAG, d))


def _f7(device) -> torch.Tensor:
    def make(d):
        f = torch.eye(7, dtype=torch.float32, device=d)
        f.diagonal(4).fill_(1.0)     # cx += vcx, cy += vcy, s += vs
        return f
    return _const("f7", device, make)


def kf_initiate(z: torch.Tensor):
    """(..., 4) measurement (cx, cy, s, r) -> mean (..., 7), cov (..., 7,
    7)."""
    z = z.float()
    mean = torch.cat([z, torch.zeros((*z.shape[:-1], 3), dtype=torch.float32,
                                     device=z.device)], dim=-1)
    cov = _diag(_P0_DIAG, z.device).expand(*z.shape[:-1], 7, 7)
    return mean, cov


def _kf_predict_bare(x: torch.Tensor, p: torch.Tensor):
    f = _f7(x.device)
    return (torch.matmul(x, f.T),
            torch.matmul(torch.matmul(f, p), f.T) + _diag(_Q_DIAG, x.device))


def kf_predict(x: torch.Tensor, p: torch.Tensor):
    """Batched predict with the SORT area-collapse guard (vs -> 0 when the
    predicted area would be non-positive)."""
    vs = torch.where(x[..., 6] + x[..., 2] <= 0, 0.0, x[..., 6])
    x = torch.cat([x[..., :6], vs[..., None]], dim=-1)
    return _kf_predict_bare(x, p)


def kf_update(x: torch.Tensor, p: torch.Tensor, z: torch.Tensor):
    """Batched Joseph-form update (filterpy's update, the official KF). H
    selects the first four state dims, so H x, P H^T and K H are slices."""
    dev = x.device
    r = _r_vec(dev)
    ph_t = p[..., :, :4]                                       # (..., 7, 4)
    s = ph_t[..., :4, :] + torch.diag(r)
    # K = P H^T S^-1: K^T = S^-1 (P H^T)^T (S symmetric)
    k = kalman._cho_solve_small(s, ph_t.transpose(-1, -2), 4) \
        .transpose(-1, -2)                                     # (..., 7, 4)
    new_x = x + torch.matmul(k, (z - x[..., :4])[..., None])[..., 0]
    i_kh = torch.eye(7, dtype=torch.float32, device=dev) \
        - torch.nn.functional.pad(k, (0, 3))
    new_p = torch.matmul(torch.matmul(i_kh, p), i_kh.transpose(-1, -2)) \
        + torch.matmul(k * r, k.transpose(-1, -2))
    return new_x, new_p


# --- box parameterizations ---------------------------------------------------

def xyxy_to_z(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (cx, cy, s=area, r=aspect); h floored at 1e-6 for
    the aspect ratio."""
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack([(b[..., 0] + b[..., 2]) / 2.0,
                        (b[..., 1] + b[..., 3]) / 2.0,
                        w * h, w / torch.clamp(h, min=1e-6)], dim=-1)


def x_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """KF state -> xyxy. Non-positive s*r yields NaN on purpose (sqrt, and
    ``clamp`` passes NaN on); the step deactivates such tracks."""
    w = torch.sqrt(x[..., 2] * x[..., 3])
    h = x[..., 2] / torch.clamp(w, min=1e-6)
    cx, cy = x[..., 0], x[..., 1]
    return torch.stack([cx - w / 2.0, cy - h / 2.0,
                        cx + w / 2.0, cy + h / 2.0], dim=-1)


def _xyxy_to_tlwh(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b[..., :2], b[..., 2:] - b[..., :2]], dim=-1)


def iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return iou_matrix(_xyxy_to_tlwh(a), _xyxy_to_tlwh(b))


def _centers(b: torch.Tensor):
    return (b[..., 0] + b[..., 2]) / 2.0, (b[..., 1] + b[..., 3]) / 2.0


def speed_direction(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Normalized (dy, dx) from box b1's center to b2's (1e-6 norm floor)."""
    cx1, cy1 = _centers(b1)
    cx2, cy2 = _centers(b2)
    dy, dx = cy2 - cy1, cx2 - cx1
    norm = torch.sqrt(dy * dy + dx * dx) + 1e-6
    return torch.stack([dy / norm, dx / norm], dim=-1)


# --- params / state ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OCSortParams:
    """Static OC-SORT hyper-parameters (official OCSort defaults).

    ``with_appearance=True`` is Deep OC-SORT: official defaults
    ``alpha_fixed_emb`` 0.95, ``w_assoc_emb`` 0.75, ``aw_param`` 0.5. Round 2
    (OCR) stays IoU-only."""
    det_thresh: float = 0.6
    max_age: int = 30
    min_hits: int = 3
    iou_threshold: float = 0.3
    delta_t: int = 3
    inertia: float = 0.2          # velocity-direction-consistency weight
    max_tracks: int = 128
    max_detections: int = 64
    with_appearance: bool = False
    feature_dim: int = 512
    alpha_fixed_emb: float = 0.95
    w_assoc_emb: float = 0.75
    aw_param: float = 0.5


@dataclasses.dataclass(frozen=True)
class OCSortState:
    """All track slots as padded tensors (T = max_tracks, K = delta_t + 1)."""
    active: torch.Tensor        # (T,) bool
    x: torch.Tensor             # (T, 7) f32 — KF mean
    p: torch.Tensor             # (T, 7, 7) f32 — KF covariance
    frozen_x: torch.Tensor      # (T, 7) f32 — state saved at first miss (ORU)
    frozen_p: torch.Tensor      # (T, 7, 7) f32
    frozen_valid: torch.Tensor  # (T,) bool
    observed: torch.Tensor      # (T,) bool — updated at its latest frame
    last_obs: torch.Tensor      # (T, 5) f32 — xyxy+score, -1s before first obs
    obs_ring: torch.Tensor      # (T, K, 4) f32 — observation boxes by age
    obs_age: torch.Tensor       # (T, K) int32 — age each slot was written (-1)
    velocity: torch.Tensor      # (T, 2) f32 — (dy, dx) between observations
    age: torch.Tensor           # (T,) int32 — predict count
    tsu: torch.Tensor           # (T,) int32 — frames since last update
    hits: torch.Tensor          # (T,) int32
    hit_streak: torch.Tensor    # (T,) int32
    track_id: torch.Tensor      # (T,) int32
    class_id: torch.Tensor      # (T,) int32
    score: torch.Tensor         # (T,) f32
    frame_count: torch.Tensor   # () int32
    next_id: torch.Tensor       # () int32
    dropped: torch.Tensor       # () int32
    # Deep OC-SORT appearance bank (None unless params.with_appearance): one
    # EMA-smoothed L2-normalized embedding per slot; zeros = none yet
    emb: Optional[torch.Tensor] = None          # (T, F) f32

    def replace(self, **changes) -> "OCSortState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class OCSortDetections:
    """Padded per-frame detections in xyxy (class-filtered only; the step
    applies the strict ``score > det_thresh`` gate itself)."""
    xyxy: torch.Tensor          # (N, 4) f32
    score: torch.Tensor         # (N,) f32
    class_id: torch.Tensor      # (N,) int32
    valid: torch.Tensor         # (N,) bool
    # ReID features (None unless the step runs with_appearance):
    feature: Optional[torch.Tensor] = None      # (N, F) f32
    has_feature: Optional[torch.Tensor] = None  # (N,) bool


def init_state(params: OCSortParams, device="cpu",
               n_streams: int | None = None) -> OCSortState:
    """Fresh state; track ids restart at 1. ``n_streams``: a stack of that
    many fresh states on a leading stream axis."""
    t, k = params.max_tracks, params.delta_t + 1
    lead = () if n_streams is None else (int(n_streams),)

    def z(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    return OCSortState(
        active=z((t,), torch.bool),
        x=z((t, 7), torch.float32),
        p=z((t, 7, 7), torch.float32),
        frozen_x=z((t, 7), torch.float32),
        frozen_p=z((t, 7, 7), torch.float32),
        frozen_valid=z((t,), torch.bool),
        observed=z((t,), torch.bool),
        last_obs=full((t, 5), -1.0, torch.float32),
        obs_ring=z((t, k, 4), torch.float32),
        obs_age=full((t, k), -1, torch.int32),
        velocity=z((t, 2), torch.float32),
        age=z((t,), torch.int32),
        tsu=z((t,), torch.int32),
        hits=z((t,), torch.int32),
        hit_streak=z((t,), torch.int32),
        track_id=z((t,), torch.int32),
        class_id=z((t,), torch.int32),
        score=z((t,), torch.float32),
        frame_count=z((), torch.int32),
        next_id=full((), 1, torch.int32),
        dropped=z((), torch.int32),
        emb=(z((t, params.feature_dim), torch.float32)
             if params.with_appearance else None),
    )


def make_detections(xyxy, score, class_id, valid=None, *,
                    feature=None, has_feature=None,
                    params: OCSortParams, device="cpu") -> OCSortDetections:
    """Pad raw per-frame detections (numpy or tensors) to the static
    capacity. ``feature``: ``(k, F)`` ReID embeddings (rows of zeros = no
    feature), used only when ``params.with_appearance``."""
    n = params.max_detections

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    xyxy = t(xyxy, torch.float32).reshape(-1, 4)
    k = xyxy.shape[0]
    if k > n:
        raise ValueError(f"{k} detections exceed capacity {n}")
    score = t(score, torch.float32).reshape(-1)
    class_id = t(class_id, torch.int32).reshape(-1)
    valid = (torch.ones((k,), dtype=torch.bool, device=device)
             if valid is None else t(valid, torch.bool).reshape(-1))
    valid = valid & torch.isfinite(xyxy).all(-1)
    feat = hasf = None
    if params.with_appearance:
        if feature is None:
            feat = torch.zeros((n, params.feature_dim), dtype=torch.float32,
                               device=device)
            hasf = torch.zeros((n,), dtype=torch.bool, device=device)
        else:
            feature = t(feature, torch.float32).reshape(
                -1, params.feature_dim)
            feat = pad_rows(feature, n)
            hasf = pad_rows(torch.any(feature != 0.0, dim=-1)
                             if has_feature is None
                             else t(has_feature, torch.bool).reshape(-1), n)
    return OCSortDetections(
        xyxy=pad_rows(xyxy, n), score=pad_rows(score, n),
        class_id=pad_rows(class_id, n), valid=pad_rows(valid, n),
        feature=feat, has_feature=hasf)


def _ring_at(ring: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Each track's ring entry at ``slot (..., T)``: ``ring (..., T, K,
    ...)`` -> ``(..., T, ...)``."""
    rest = ring.shape[slot.ndim + 1:]
    idx = slot.reshape(slot.shape + (1,) * (1 + len(rest))).expand(
        slot.shape + (1,) + rest)
    return torch.gather(ring, slot.ndim, idx).squeeze(slot.ndim)


def _ring_set(ring: torch.Tensor, slot: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """A copy of ``ring`` with each track's entry at ``slot`` set to
    ``values (..., T, ...)``."""
    rest = ring.shape[slot.ndim + 1:]
    idx = slot.reshape(slot.shape + (1,) * (1 + len(rest))).expand(
        slot.shape + (1,) + rest)
    return ring.scatter(slot.ndim, idx, values.unsqueeze(slot.ndim))


def _row_take(m: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """``m[..., t, j[..., t]]``: each row's entry at its column."""
    return torch.gather(m, -1, j[..., None])[..., 0]


def _previous_obs(state: OCSortState, params: OCSortParams):
    """Vectorized k_previous_obs: the observation at age - dt for the
    largest dt <= delta_t that exists, else the most recent observation
    (= last_obs). Returns (boxes (..., T, 4), valid (..., T))."""
    k_ring = params.delta_t + 1
    prev = state.last_obs[..., :4]
    found = torch.zeros_like(state.active)
    for dt in range(params.delta_t, 0, -1):
        target = state.age - dt
        slot = torch.remainder(target, k_ring).long()
        hit = (_ring_at(state.obs_age, slot) == target) & (target >= 0) \
            & ~found
        prev = torch.where(hit[..., None], _ring_at(state.obs_ring, slot),
                           prev)
        found = found | hit
    return prev, state.last_obs[..., 4] >= 0


def _aw_weight_matrix(sim: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, w_emb: float,
                      bottom: float) -> torch.Tensor:
    """Deep OC-SORT adaptive weighting (official compute_aw_max_metric,
    vectorized): per row and per column the embedding weight is ``1 -
    max(second/first - bottom, 0) / (1 - bottom)`` over the top-2 entries, 0
    when the best is exactly 0, 1 when fewer than two candidates exist,
    clamped to [0, 1]. The matrix is ``w_emb * row_weight * col_weight``.
    ``rows`` / ``cols`` mask the real tracks and detections; masked entries
    stay out of the top-2."""
    valid = rows[..., :, None] & cols[..., None, :]
    masked = torch.where(valid, sim, -math.inf)

    def axis_weight(m, n_valid):
        top2 = torch.topk(m, 2, dim=-1).values
        first, second = top2[..., 0], top2[..., 1]
        safe_first = torch.where(first == 0.0, 1.0, first)
        w = 1.0 - torch.clamp(second / safe_first - bottom, min=0.0) \
            / (1.0 - bottom)
        w = torch.where(first == 0.0, 0.0, w)
        w = torch.where(n_valid < 2, 1.0, w)  # official: continue (keep w)
        return torch.clamp(w, 0.0, 1.0)

    row_w = axis_weight(masked, torch.sum(valid, dim=-1))
    col_w = axis_weight(masked.transpose(-1, -2), torch.sum(valid, dim=-2))
    return w_emb * row_w[..., :, None] * col_w[..., None, :]


def _associate_ocm(iou: torch.Tensor, bonus: torch.Tensor,
                   rows: torch.Tensor, cols: torch.Tensor,
                   iou_threshold: float,
                   emb_term: Optional[torch.Tensor] = None,
                   emb_bound: float = 0.0) -> torch.Tensor:
    """First-round association: maximize IoU + OCM bonus (+ the weighted
    appearance term), accept IoU >= threshold; with the official shortcut:
    when the IoU-above-threshold adjacency already is a partial matching
    (every row and column sum <= 1, with a max of exactly 1), take it in
    place of the assignment solve. Both are computed and the shortcut's
    matches selected where it holds, as ``jax.vmap`` of JAX's ``lax.cond``
    computes them; with no row or column the solve matches nothing."""
    a = rows[..., :, None] & cols[..., None, :] & (iou > iou_threshold)
    row_sums = torch.sum(a, dim=-1)
    col_sums = torch.sum(a, dim=-2)
    run = torch.any(rows, dim=-1) & torch.any(cols, dim=-1)
    shortcut_ok = run & (torch.amax(row_sums, dim=-1) == 1) \
        & (torch.amax(col_sums, dim=-1) == 1)
    # each row has at most one adjacent column (and the reverse)
    short = torch.where(row_sums == 1,
                        torch.argmax(a.to(torch.uint8), dim=-1), -1)
    # plain max-sum assignment (the official lapjv call has no cost limit):
    # shift to non-negative costs (the bonus can be negative, down to
    # -inertia/2); the feasibility bound exceeds every possible cost, so
    # nothing is clamped, and the filter below applies the IoU >= threshold
    # rejection. The bound stays modest: a huge sentinel would swamp the f32
    # dual arithmetic of the solver.
    objective = iou + bonus
    if emb_term is not None:
        objective = objective + emb_term
    shift = 3.0 + emb_bound
    solved = min_cost_matching(shift - objective, rows, cols,
                               shift + 1.0 + emb_bound)
    match = torch.where(shortcut_ok[..., None], short, solved)
    ok = (match >= 0) & (_row_take(iou, torch.clamp(match, min=0))
                         >= iou_threshold)
    return torch.where(ok, match, -1)


def oru_replay_plain(x, p, frozen_x, frozen_p, replay, gap, z1, z2,
                     max_gap: int):
    """The ORU replay (the JAX module's ``do_replay``), plain: slots where
    ``replay`` roll back to the frozen state and replay ``gap`` virtual
    steps along the line from observation ``z1`` to ``z2`` (cx, cy, s, r):
    a Joseph-form update at each, the bare predict between two. A masked
    loop of ``max_gap`` iterations (a live track's ``gap`` is at most
    ``max_age + 1``): the extra ones are no-ops, and nothing is read back.
    Shapes ``(..., T, 7)``, ``(..., T, 7, 7)``, ``(..., T)`` bool and int32,
    ``(..., T, 4)``; returns ``(x, p)``."""
    x = torch.where(replay[..., None], frozen_x, x)
    p = torch.where(replay[..., None, None], frozen_p, p)
    w1 = torch.sqrt(torch.clamp(z1[..., 2] * z1[..., 3], min=0.0))
    h1 = torch.sqrt(torch.clamp(
        z1[..., 2] / torch.clamp(z1[..., 3], min=1e-6), min=0.0))
    w2 = torch.sqrt(torch.clamp(z2[..., 2] * z2[..., 3], min=0.0))
    h2 = torch.sqrt(torch.clamp(
        z2[..., 2] / torch.clamp(z2[..., 3], min=1e-6), min=0.0))
    g = torch.clamp(gap, min=1).float()
    dxc = (z2[..., 0] - z1[..., 0]) / g
    dyc = (z2[..., 1] - z1[..., 1]) / g
    dw = (w2 - w1) / g
    dh = (h2 - h1) / g
    for i in range(1, max_gap + 1):
        live = replay & (i <= gap)
        fi = float(i)
        wi = w1 + fi * dw
        hi = h1 + fi * dh
        zi = torch.stack([z1[..., 0] + fi * dxc, z1[..., 1] + fi * dyc,
                          wi * hi, wi / torch.clamp(hi, min=1e-6)], dim=-1)
        ux, up = kf_update(x, p, zi)
        x = torch.where(live[..., None], ux, x)
        p = torch.where(live[..., None, None], up, p)
        # predict between virtual steps, not after the last one (the
        # official unfreeze calls the bare KF predict: no area guard)
        mid = live & (i < gap)
        px, pp = _kf_predict_bare(x, p)
        x = torch.where(mid[..., None], px, x)
        p = torch.where(mid[..., None, None], pp, p)
    return x, p


def oru_replay(x, p, frozen_x, frozen_p, replay, gap, z1, z2,
               max_gap: int, variant: str = _oru_kernel.VARIANTS[0]):
    """:func:`oru_replay_plain`'s function. CUDA tensors: the kernel
    (``ops/oru.py``, one launch for every slot of every stream, nothing read
    back; ``variant`` names its design, ``"rows"`` by default); CPU tensors:
    :func:`oru_replay_plain`, whatever the design named."""
    args = (x, p, frozen_x, frozen_p, replay, gap, z1, z2)
    _oru_kernel.check_args(*args)
    _oru_kernel.check_variant(variant)
    if x.device.type == "cuda":
        return _oru_kernel.KERNEL(*args, max_gap, variant)
    if x.device.type != "cpu":
        raise ValueError(f"the ORU replay runs on CUDA or CPU tensors (got "
                         f"{x.device})")
    return oru_replay_plain(*args, max_gap)


@torch.no_grad()
def step(state: OCSortState, dets: OCSortDetections,
         params: OCSortParams, gmc=None) -> OCSortState:
    """One OC-SORT frame update (predict, OCM association, OCR recovery, ORU
    re-update, lifecycle), after ``OCSort.update``. Returns a new state;
    ``state`` is left as it was. ``gmc``: the camera affine ``(A, t)`` of
    this frame (``ops/gmc.py``; ``(S, 2, 2)`` and ``(S, 2)`` for a stack),
    which warps the Kalman bank and the observation history after the
    prediction."""
    k_ring = params.delta_t + 1
    dev = state.x.device
    frame_count = state.frame_count + 1

    # strict input gate (official: scores > det_thresh)
    d_ok = dets.valid & (dets.score > params.det_thresh)

    # --- predict all active tracks -------------------------------------------
    px, pp = kf_predict(state.x, state.p)
    x = torch.where(state.active[..., None], px, state.x)
    p = torch.where(state.active[..., None, None], pp, state.p)
    if gmc is not None:
        state = warp_ocsort_state(state.replace(x=x, p=p), gmc[0], gmc[1])
        x, p = state.x, state.p
    hit_streak = torch.where(state.active & (state.tsu > 0), 0,
                             state.hit_streak)
    tsu = torch.where(state.active, state.tsu + 1, state.tsu)
    age = torch.where(state.active, state.age + 1, state.age)
    trk_boxes = x_to_xyxy(x)
    # a track whose predicted box went NaN (sqrt of a negative s*r) dies
    # this frame, as the official to_del removal
    active = state.active & torch.isfinite(trk_boxes).all(-1)
    prev_obs, prev_valid = _previous_obs(state.replace(age=age), params)

    iou = iou_xyxy(trk_boxes, dets.xyxy)  # (..., T, N)

    # OCM velocity-direction-consistency bonus. pi as a tensor (a fill): a
    # division by a Python float becomes a multiplication by its reciprocal
    # on CUDA.
    pi = torch.full((), math.pi, dtype=torch.float32, device=dev)
    dirs = speed_direction(prev_obs[..., :, None, :],
                           dets.xyxy[..., None, :, :])
    cos = torch.clamp(state.velocity[..., :, None, 0] * dirs[..., 0]
                      + state.velocity[..., :, None, 1] * dirs[..., 1],
                      -1.0, 1.0)
    diff_angle = (pi / 2.0 - torch.abs(torch.acos(cos))) / pi
    bonus = torch.where(prev_valid[..., None], diff_angle, 0.0) \
        * params.inertia * dets.score[..., None, :]

    # Deep OC-SORT: raw cosine similarity (embeddings are unit norm; a
    # full-f32 matmul), zeroed where boxes don't overlap, scaled by the
    # per-pair adaptive weight.
    if params.with_appearance:
        sim = state.emb @ dets.feature.transpose(-1, -2)
        sim = torch.where((iou > 0.0) & dets.has_feature[..., None, :], sim,
                          0.0)
        emb_term = sim * _aw_weight_matrix(
            sim, active, d_ok, params.w_assoc_emb, params.aw_param)
        emb_bound = float(params.w_assoc_emb)
    else:
        emb_term = None
        emb_bound = 0.0

    # --- round 1: OCM association --------------------------------------------
    match1 = _associate_ocm(iou, bonus, active, d_ok, params.iou_threshold,
                            emb_term=emb_term, emb_bound=emb_bound)
    u_det = _claim(match1, d_ok)

    # --- round 2: OCR — recover by last observation box. The solve always
    # runs; its matches stand under the official guard: some leftover pair
    # exceeds the threshold. --------------------------------------------------
    r_rows = active & (match1 < 0)
    iou_last = iou_xyxy(state.last_obs[..., :4], dets.xyxy)
    any_left = torch.any(torch.where(
        r_rows[..., :, None] & u_det[..., None, :], iou_last, 0.0)
        > params.iou_threshold, dim=-1).any(-1)
    m = min_cost_matching(1.0 - iou_last, r_rows, u_det, 1.0)
    ok = any_left[..., None] & (m >= 0) & (
        _row_take(iou_last, torch.clamp(m, min=0)) >= params.iou_threshold)
    match2 = torch.where(ok, m, -1)

    match = torch.where(match1 >= 0, match1, match2)
    matched = match >= 0
    det_idx = torch.clamp(match, min=0)
    u_det = _claim(match2, u_det)

    # --- ORU: roll back + replay along the virtual trajectory ----------------
    z2 = _take(xyxy_to_z(dets.xyxy), det_idx)  # (..., T, 4) per slot
    replay = matched & ~state.observed & state.frozen_valid \
        & (state.last_obs[..., 4] >= 0)
    gap = torch.where(replay, tsu, 0)
    x, p = oru_replay(x, p, state.frozen_x, state.frozen_p, replay, gap,
                      xyxy_to_z(state.last_obs[..., :4]), z2,
                      params.max_age + 1)

    # --- real measurement update for every matched track ---------------------
    ux, up = kf_update(x, p, z2)
    x = torch.where(matched[..., None], ux, x)
    p = torch.where(matched[..., None, None], up, p)

    # velocity from the previous observation to the new one (only for
    # tracks that had one)
    det_box = _take(dets.xyxy, det_idx)
    det_score = _take(dets.score, det_idx)
    new_vel = speed_direction(prev_obs, det_box)
    velocity = torch.where((matched & prev_valid)[..., None], new_vel,
                           state.velocity)

    # observation bookkeeping
    last_obs = torch.where(
        matched[..., None], torch.cat([det_box, det_score[..., None]], dim=-1),
        state.last_obs)
    slot = torch.remainder(age, k_ring).long()
    obs_ring = _ring_set(state.obs_ring, slot, torch.where(
        matched[..., None], det_box, _ring_at(state.obs_ring, slot)))
    obs_age = _ring_set(state.obs_age, slot, torch.where(
        matched, age, _ring_at(state.obs_age, slot)))

    hits = torch.where(matched, state.hits + 1, state.hits)
    hit_streak = torch.where(matched, hit_streak + 1, hit_streak)
    tsu = torch.where(matched, 0, tsu)
    score = torch.where(matched, det_score, state.score)
    class_id = torch.where(matched, _take(dets.class_id, det_idx),
                           state.class_id)

    # Deep OC-SORT dynamic-appearance EMA: alpha = af + (1 - af)(1 - trust),
    # trust the detection confidence rescaled above det_thresh. Detections
    # without a feature leave the bank unchanged.
    emb = state.emb
    if params.with_appearance:
        trust = (dets.score - params.det_thresh) / torch.full(
            (), max(1.0 - params.det_thresh, 1e-6), dtype=torch.float32,
            device=dev)
        af = params.alpha_fixed_emb
        alpha = _take(af + (1.0 - af) * (1.0 - trust), det_idx)
        new_emb = alpha[..., None] * state.emb \
            + (1.0 - alpha)[..., None] * _take(dets.feature, det_idx)
        new_emb = new_emb / torch.clamp(torch.linalg.vector_norm(
            new_emb, dim=-1, keepdim=True), min=1e-12)
        upd = matched & _take(dets.has_feature, det_idx)
        emb = torch.where(upd[..., None], new_emb, state.emb)

    # --- misses: freeze at the first one (ORU anchor) -------------------------
    missed = active & ~matched
    freeze = missed & state.observed
    frozen_x = torch.where(freeze[..., None], x, state.frozen_x)
    frozen_p = torch.where(freeze[..., None, None], p, state.frozen_p)
    frozen_valid = state.frozen_valid | freeze
    observed = (state.observed | matched) & ~missed

    # --- removal ---------------------------------------------------------------
    active = active & ~(missed & (tsu > params.max_age))

    # --- new tracks (with none, every scatter drops everything and n_new,
    # dropped are 0) --------------------------------------------------------
    slot_for_det, det_rank, n_new, dropped = place_new_tracks(active, u_det)
    init_x, init_p = kf_initiate(xyxy_to_z(dets.xyxy))
    lead = u_det.shape

    def scatter(arr, values):
        return _scatter_drop(arr, slot_for_det, values)

    def fill(arr, value):
        rest = arr.shape[len(lead):]
        return scatter(arr, torch.full(lead + rest, value, dtype=arr.dtype,
                                       device=dev))

    active = fill(active, True)
    x = scatter(x, init_x)
    p = scatter(p, init_p)
    # official KalmanBoxTracker.__init__: last_observation stays -1s, no
    # ring entry, velocity None, counters zero, observed False
    last_obs = fill(last_obs, -1.0)
    obs_ring = fill(obs_ring, 0.0)
    obs_age = fill(obs_age, -1)
    velocity = fill(velocity, 0.0)
    age = fill(age, 0)
    tsu = fill(tsu, 0)
    hits = fill(hits, 0)
    hit_streak = fill(hit_streak, 0)
    observed = fill(observed, False)
    frozen_valid = fill(frozen_valid, False)
    track_id = scatter(state.track_id, state.next_id[..., None] + det_rank)
    class_id = scatter(class_id, dets.class_id)
    score = scatter(score, dets.score)
    if emb is not None:
        # seed the bank with the detection embedding; none -> zeros
        emb = scatter(emb, torch.where(dets.has_feature[..., None],
                                       dets.feature, 0.0))

    return state.replace(
        active=active, x=x, p=p,
        frozen_x=frozen_x, frozen_p=frozen_p, frozen_valid=frozen_valid,
        observed=observed, last_obs=last_obs,
        obs_ring=obs_ring, obs_age=obs_age, velocity=velocity,
        age=age, tsu=tsu, hits=hits, hit_streak=hit_streak,
        track_id=track_id, class_id=class_id, score=score,
        frame_count=frame_count, next_id=state.next_id + n_new,
        dropped=state.dropped + dropped,
        emb=emb,
    )


def get_outputs(state: OCSortState, params: OCSortParams):
    """Tracks updated this frame with enough history, as (xyxy, id, class,
    score, mask). Boxes are the last observation (the matched detection), not
    the Kalman state. Emission: tsu < 1 and (hit_streak >= min_hits or within
    the first min_hits frames)."""
    has_obs = state.last_obs[..., 4] >= 0
    box = torch.where(has_obs[..., None], state.last_obs[..., :4],
                      x_to_xyxy(state.x))
    z = (state.active & (state.tsu < 1)
         & ((state.hit_streak >= params.min_hits)
            | (state.frame_count[..., None] <= params.min_hits)))
    box = torch.where(torch.isfinite(box), box, 0.0)
    return (torch.where(z[..., None], box, 0.0),
            torch.where(z, state.track_id, 0),
            torch.where(z, state.class_id, 0),
            torch.where(z, state.score, 0.0),
            z)
