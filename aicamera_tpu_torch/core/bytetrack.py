"""ByteTrack: two-pass IoU association over every detection box.

The port of ``aicamera_tpu/core/bytetrack.py`` (Zhang et al., ECCV 2022,
arXiv:2110.06864), fixed shape like the DeepSORT core (:mod:`.tracker`):

- **High/low score split.** Detections above ``track_thresh`` associate
  first (IoU, optionally score-fused); leftover *tracked* tracks then get a
  second chance against the low-score boxes (``low_thresh < s <
  track_thresh``).
- **Lifecycle.** New tracks start unconfirmed (``is_activated=False`` except
  on frame 1) and must re-match the next frame or die; unmatched tracked
  tracks become LOST and are revived by the first association for up to
  ``max_time_lost`` frames; duplicate tracked/lost pairs (IoU cost < 0.15)
  drop the shorter-lived twin.
- **BoT-SORT mode** (``ByteTrackParams(with_appearance=True)``, Aharon et
  al. 2022, arXiv:2206.14651): stages 1 and 3 take ``min(iou_cost,
  emb_cost)`` with the official proximity/appearance masking, and every
  track keeps one EMA-smoothed L2-normalized ReID embedding. With
  ``with_appearance=False`` the appearance fields stay ``None``.

The matching threshold convention is "accept when cost <= thresh"
(:func:`.assignment.min_cost_matching`).

The step reads nothing back from its device. Where the JAX package skips a
stage with a ``lax.cond`` (the prediction of an empty pool, each of the three
association stages, the matched tracks' corrections, the births, the
duplicate removal), the port computes the stage on the masks it already has
and selects with ``torch.where``: what ``jax.vmap`` of the JAX step computes.
A stage with no eligible row or column matches nothing, a masked update
leaves every masked slot as it was, and a birth with no new detection drops
every scatter, so the result is the skipped branch's. One code path serves
the CPU and the GPU, and a chunk's steps can be captured in one CUDA graph
(``runtime/pipeline.py``).

Every function also takes states and detections with leading stream axes
(``ByteTrackState`` fields ``(S, T, ...)``, the counters ``(S,)``;
``ByteDetections`` fields ``(S, N, ...)``): the counterpart of ``jax.vmap``
of the JAX step over streams. A stage's assignment problems of all streams
go to the kernel as one batch. One stream is the call without the axis.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.gmc import warp_xyah_bank
from . import kalman
from .assignment import (_claim, _scatter_drop, _take, min_cost_matching,
                         place_new_tracks)
from .costs import (_l2_normalize, iou_cost_matrix, mean_to_tlwh,
                    tlwh_to_tlbr, tlwh_to_xyah)
from .state import pad_rows

TRACKED = 1
LOST = 2


@dataclasses.dataclass(frozen=True)
class ByteTrackParams:
    """Static ByteTrack hyper-parameters.

    Defaults are the official BYTETracker demo settings: track_thresh 0.5,
    match_thresh 0.8, track_buffer 30 (= max_time_lost at the source frame
    rate), second-stage threshold 0.5, unconfirmed-stage threshold 0.7,
    low-score floor 0.1, new-track threshold track_thresh + 0.1.

    ``with_appearance=True`` is BoT-SORT's association: ``emb_cost =
    cosine_distance / 2``, set to 1 beyond ``appearance_thresh`` or where the
    raw IoU cost exceeds ``proximity_thresh``; each track keeps one EMA
    embedding (``feat_ema_alpha``, official default 0.9).
    """
    track_thresh: float = 0.5
    match_thresh: float = 0.8
    second_match_thresh: float = 0.5
    unconfirmed_match_thresh: float = 0.7
    low_thresh: float = 0.1
    det_thresh: float = -1.0          # < 0: track_thresh + 0.1
    max_time_lost: int = 30
    fuse_score: bool = True           # official mot20=False path
    dup_iou_cost: float = 0.15
    max_tracks: int = 128
    max_detections: int = 64
    with_appearance: bool = False
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.25
    feat_ema_alpha: float = 0.9
    feature_dim: int = 512

    @property
    def new_track_thresh(self) -> float:
        return (self.det_thresh if self.det_thresh >= 0
                else self.track_thresh + 0.1)


@dataclasses.dataclass(frozen=True)
class ByteTrackState:
    """All track slots as padded tensors (T = max_tracks)."""
    active: torch.Tensor        # (T,) bool — slot holds a live track
    state: torch.Tensor         # (T,) int32 — TRACKED / LOST
    is_activated: torch.Tensor  # (T,) bool — confirmed by a second match
    mean: torch.Tensor          # (T, 8) f32 — KF state mean (cx,cy,a,h,v*)
    cov: torch.Tensor           # (T, 8, 8) f32
    tsu: torch.Tensor           # (T,) int32 — frames since last update
    start_frame: torch.Tensor   # (T,) int32 — frame the track activated
    track_id: torch.Tensor      # (T,) int32
    class_id: torch.Tensor      # (T,) int32
    score: torch.Tensor         # (T,) f32 — last matched detection score
    frame_id: torch.Tensor      # () int32 — frames processed so far
    next_id: torch.Tensor       # () int32
    dropped: torch.Tensor       # () int32 — detections dropped to capacity
    # BoT-SORT appearance bank (None unless params.with_appearance):
    feat: torch.Tensor | None = None      # (T, D) f32 — EMA, L2-normalized
    has_feat: torch.Tensor | None = None  # (T,) bool

    def replace(self, **changes) -> "ByteTrackState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class ByteDetections:
    """Padded per-frame detections (class-filtered; not score-split: the
    step splits by score itself)."""
    tlwh: torch.Tensor          # (N, 4) f32
    score: torch.Tensor         # (N,) f32
    class_id: torch.Tensor      # (N,) int32
    valid: torch.Tensor         # (N,) bool
    # ReID features (None unless the step runs with_appearance):
    feature: torch.Tensor | None = None      # (N, D) f32
    has_feature: torch.Tensor | None = None  # (N,) bool


def init_state(params: ByteTrackParams, device="cpu",
               n_streams: int | None = None) -> ByteTrackState:
    """Fresh state; track ids restart at 1. ``n_streams``: a stack of that
    many fresh states on a leading stream axis."""
    t = params.max_tracks
    lead = () if n_streams is None else (int(n_streams),)

    def z(shape, dtype):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    app = params.with_appearance
    return ByteTrackState(
        active=z((t,), torch.bool),
        state=z((t,), torch.int32),
        is_activated=z((t,), torch.bool),
        mean=z((t, 8), torch.float32),
        cov=z((t, 8, 8), torch.float32),
        tsu=z((t,), torch.int32),
        start_frame=z((t,), torch.int32),
        track_id=z((t,), torch.int32),
        class_id=z((t,), torch.int32),
        score=z((t,), torch.float32),
        frame_id=z((), torch.int32),
        next_id=torch.ones(lead, dtype=torch.int32, device=device),
        dropped=z((), torch.int32),
        feat=z((t, params.feature_dim), torch.float32) if app else None,
        has_feat=z((t,), torch.bool) if app else None,
    )


def make_detections(tlwh, score, class_id, valid=None, feature=None, *,
                    params: ByteTrackParams, device="cpu") -> ByteDetections:
    """Pad raw per-frame detections (numpy or tensors) to the static
    capacity. ``feature``: ``(k, D)`` ReID embeddings (rows of zeros = no
    feature), used only when ``params.with_appearance``."""
    n = params.max_detections

    def t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    tlwh = t(tlwh, torch.float32).reshape(-1, 4)
    k = tlwh.shape[0]
    if k > n:
        raise ValueError(f"{k} detections exceed capacity {n}")
    score = t(score, torch.float32).reshape(-1)
    class_id = t(class_id, torch.int32).reshape(-1)
    valid = (torch.ones((k,), dtype=torch.bool, device=device)
             if valid is None else t(valid, torch.bool).reshape(-1))
    valid = valid & torch.isfinite(tlwh).all(-1)
    feat = has_feat = None
    if params.with_appearance:
        d = params.feature_dim
        f = (torch.zeros((k, d), dtype=torch.float32, device=device)
             if feature is None else t(feature, torch.float32).reshape(k, d))
        feat = pad_rows(f, n)
        has_feat = pad_rows(torch.any(f != 0.0, dim=-1), n)
    return ByteDetections(
        tlwh=pad_rows(tlwh, n), score=pad_rows(score, n),
        class_id=pad_rows(class_id, n), valid=pad_rows(valid, n),
        feature=feat, has_feature=has_feat)


@torch.no_grad()
def step(state: ByteTrackState, dets: ByteDetections,
         params: ByteTrackParams, gmc=None) -> ByteTrackState:
    """One ByteTrack frame update (predict, three association stages,
    lifecycle), after the official ``BYTETracker.update`` loop. Returns a new
    state; ``state`` is left as it was. ``gmc``: the camera affine ``(A,
    t)`` of this frame (``ops/gmc.py``; ``(S, 2, 2)`` and ``(S, 2)`` for a
    stack), which warps the Kalman bank after the prediction."""
    dev = state.mean.device
    frame_id = state.frame_id + 1

    # --- Predict the association pool (tracked + lost, i.e. activated) ------
    # Unconfirmed tracks are not predicted; lost tracks predict with vh
    # zeroed (official STrack.multi_predict).
    pool = state.active & state.is_activated
    mean0 = state.mean.clone()
    mean0[..., 7] = torch.where(pool & (state.state != TRACKED), 0.0,
                                state.mean[..., 7])
    pm, pc = kalman.predict(mean0, state.cov)
    mean = torch.where(pool[..., None], pm, mean0)
    cov = torch.where(pool[..., None, None], pc, state.cov)
    if gmc is not None:
        mean, cov = warp_xyah_bank(mean, cov, gmc[0], gmc[1], state.active)
    tsu = torch.where(state.active, state.tsu + 1, state.tsu)

    # --- Score split (official: s > thresh high; low < s < thresh low;
    # s == thresh falls in neither) -------------------------------------------
    high = dets.valid & (dets.score > params.track_thresh)
    low = dets.valid & (dets.score > params.low_thresh) \
        & (dets.score < params.track_thresh)

    iou_c = iou_cost_matrix(mean_to_tlwh(mean), dets.tlwh)  # (..., T, N)
    if params.fuse_score:
        fused = 1.0 - (1.0 - iou_c) * dets.score[..., None, :]
    else:
        fused = iou_c
    if params.with_appearance:
        # BoT-SORT: emb = cosine_distance / 2, set to 1 beyond
        # appearance_thresh, where the raw IoU cost exceeds proximity_thresh
        # or where either side has no feature; the stage cost is
        # min(score-fused IoU, emb). The product is a full-f32 matmul.
        emb = 0.5 * torch.clamp(
            1.0 - _l2_normalize(state.feat)
            @ _l2_normalize(dets.feature).transpose(-1, -2), min=0.0)
        emb_bad = ((emb > params.appearance_thresh)
                   | (iou_c > params.proximity_thresh)
                   | ~state.has_feat[..., :, None]
                   | ~dets.has_feature[..., None, :])
        fused = torch.minimum(fused, torch.where(emb_bad, 1.0, emb))

    # --- Stage 1: pool (tracked + lost) vs high-score detections. Every
    # stage runs: with no eligible row or column it matches nothing. --------
    match_a = min_cost_matching(fused, pool, high, params.match_thresh)
    matched_a = match_a >= 0
    u_high = _claim(match_a, high)

    # --- Stage 2: leftover tracked tracks vs low-score detections; stage 3:
    # unconfirmed tracks vs leftover high-score detections -------------------
    r_tracked = pool & ~matched_a & (state.state == TRACKED)
    unconfirmed = state.active & ~state.is_activated
    match_b = min_cost_matching(iou_c, r_tracked, low,
                                params.second_match_thresh)
    matched_b = match_b >= 0
    newly_lost = r_tracked & ~matched_b
    match_c = min_cost_matching(fused, unconfirmed, u_high,
                                params.unconfirmed_match_thresh)
    matched_c = match_c >= 0
    remove_unconfirmed = unconfirmed & ~matched_c
    u_high = _claim(match_c, u_high)

    # Row sets of the three stages are disjoint: one merged match vector
    # drives a single masked KF update.
    match = torch.where(matched_a, match_a,
                        torch.where(matched_b, match_b, match_c))
    matched = match >= 0
    det_idx = torch.clamp(match, min=0)

    tsu = torch.where(matched, 0, tsu)
    st = torch.where(matched, TRACKED, state.state)
    st = torch.where(newly_lost, LOST, st)
    is_act = state.is_activated | matched
    score = torch.where(matched, _take(dets.score, det_idx), state.score)
    class_id = torch.where(matched, _take(dets.class_id, det_idx),
                           state.class_id)

    # --- Removals: dead unconfirmed + stale lost -----------------------------
    remove_lost = state.active & (st == LOST) & (tsu > params.max_time_lost)
    active = state.active & ~remove_unconfirmed & ~remove_lost
    new_det = u_high & (dets.score >= params.new_track_thresh)

    # --- Matched tracks: KF correction (every slot computed, the unmatched
    # ones keep their values) -------------------------------------------------
    um, uc = kalman.update(mean, cov,
                           _take(tlwh_to_xyah(dets.tlwh), det_idx))
    mean2 = torch.where(matched[..., None], um, mean)
    cov2 = torch.where(matched[..., None, None], uc, cov)
    feat, has_feat = state.feat, state.has_feat
    if params.with_appearance:
        # STrack.update_features: normalize the new feature, blend it
        # into the bank, re-normalize; the first feature seeds directly.
        fn = _l2_normalize(_take(dets.feature, det_idx))
        # 1 - a in f32, as in JAX; a fill, not a copy from the host
        a = torch.full((), params.feat_ema_alpha, dtype=torch.float32,
                       device=dev)
        blend = _l2_normalize(a * feat + (1.0 - a) * fn)
        newf = torch.where(has_feat[..., None], blend, fn)
        updm = matched & _take(dets.has_feature, det_idx)
        feat = torch.where(updm[..., None], newf, feat)
        has_feat = has_feat | updm

    # --- New tracks from the remaining high-score detections (with none,
    # every scatter drops everything and n_new, dropped are 0) ---------------
    slot_for_det, det_rank, n_new, dropped = place_new_tracks(active,
                                                              new_det)
    init_mean, init_cov = kalman.initiate(tlwh_to_xyah(dets.tlwh))
    lead = new_det.shape

    def scatter(arr, values):
        return _scatter_drop(arr, slot_for_det, values)

    active = scatter(active, torch.ones_like(new_det))
    st = scatter(st, torch.full_like(det_rank, TRACKED))
    # official STrack.activate: is_activated only on the first frame
    is_act = scatter(is_act, (frame_id == 1)[..., None].expand(lead))
    mean2 = scatter(mean2, init_mean)
    cov2 = scatter(cov2, init_cov)
    tsu = scatter(tsu, torch.zeros_like(det_rank))
    start_frame = scatter(state.start_frame, frame_id[..., None].expand(lead))
    track_id = scatter(state.track_id, state.next_id[..., None] + det_rank)
    class_id = scatter(class_id, dets.class_id)
    score = scatter(score, dets.score)
    if params.with_appearance:
        # seed the bank with the detection's normalized feature
        feat = scatter(feat, torch.where(
            dets.has_feature[..., None], _l2_normalize(dets.feature), 0.0))
        has_feat = scatter(has_feat, dets.has_feature)

    # --- Duplicate suppression (official remove_duplicate_stracks) ----------
    # Tracked/lost pairs with IoU cost < dup_iou_cost drop the shorter-lived
    # track (ties drop the tracked one, as the official `timep > timeq`).
    # With no lost track no pair qualifies.
    a_mask = active & (st == TRACKED)
    b_mask = active & (st == LOST)
    cur_tlwh = mean_to_tlwh(mean2)
    d = iou_cost_matrix(cur_tlwh, cur_tlwh)
    pairs = a_mask[..., :, None] & b_mask[..., None, :] \
        & (d < params.dup_iou_cost)
    life = (frame_id[..., None] - tsu) - start_frame
    a_older = life[..., :, None] > life[..., None, :]
    dup_b = torch.any(pairs & a_older, dim=-2)
    dup_a = torch.any(pairs & ~a_older, dim=-1)
    active = active & ~(a_mask & dup_a) & ~(b_mask & dup_b)

    return state.replace(
        active=active, state=st, is_activated=is_act,
        mean=mean2, cov=cov2, tsu=tsu, start_frame=start_frame,
        track_id=track_id, class_id=class_id, score=score,
        frame_id=frame_id, next_id=state.next_id + n_new,
        dropped=state.dropped + dropped,
        feat=feat, has_feat=has_feat,
    )


def get_outputs(state: ByteTrackState):
    """Activated tracked tracks updated this frame, as (tlbr, id, class,
    score, mask); masked lanes are zeros."""
    tlwh = mean_to_tlwh(state.mean)
    tlwh = torch.cat([tlwh[..., :2], torch.clamp(tlwh[..., 2:], min=0.0)],
                     dim=-1)
    tlbr = tlwh_to_tlbr(tlwh)
    z = (state.active & (state.state == TRACKED)
         & state.is_activated & (state.tsu == 0))
    return (torch.where(z[..., None], tlbr, 0.0),
            torch.where(z, state.track_id, 0),
            torch.where(z, state.class_id, 0),
            torch.where(z, state.score, 0.0),
            z)
