"""DeepSORT tracker step: predict, associate, update, manage.

The port of ``aicamera_tpu/core/tracker.py``. Two functions over
:class:`~.state.TrackerState` (each returns a new state; the old one is left
as it was):

- :func:`predict` — KF prediction + age/tsu counters for every active slot;
- :func:`update` — gated-appearance matching cascade for confirmed tracks,
  IoU matching for tentative and just-missed confirmed tracks, masked KF
  corrections, gallery appends, confirmations, deletions and new tracks.

Lifecycle semantics: confirm at ``hits >= n_init``; tentative tracks die on
their first miss; confirmed tracks die when ``tsu > max_age``; new tracks
take the lowest free slots and sequential ids in detection order.

The step reads nothing back from its device: where the JAX package skips a
stage with a ``lax.cond`` (no active track, no confirmed track or no
detection with a feature, no match, no new detection), the port computes
the stage on the masks it already has and selects with ``torch.where``. The
skip branches return their inputs unchanged and the masked stages leave
every masked slot as it was, so the result is the same; garbage in unused
slots (a Kalman state that is not positive definite gives NaN in
``kalman._chol_small``) is discarded by the selects. So one code path
serves the CPU and the GPU, and a chunk's steps can be captured in one CUDA
graph (``runtime/pipeline.py``).
"""

from __future__ import annotations

import torch

from . import kalman
from .assignment import (_claim, _scatter_drop, matching_cascade,
                         min_cost_matching, place_new_tracks)
from .costs import (INFTY_COST, appearance_cost_matrix, iou_cost_matrix,
                    mean_to_tlwh, tlwh_to_tlbr, tlwh_to_xyah)
from .state import CONFIRMED, TENTATIVE, Detections, TrackerParams, \
    TrackerState


def predict(state: TrackerState, params: TrackerParams) -> TrackerState:
    """KF-predict all active tracks; age += 1, time_since_update += 1."""
    new_mean, new_cov = kalman.predict(state.mean, state.cov)
    act = state.active
    return state.replace(
        mean=torch.where(act[:, None], new_mean, state.mean),
        cov=torch.where(act[:, None, None], new_cov, state.cov),
        age=torch.where(act, state.age + 1, state.age),
        tsu=torch.where(act, state.tsu + 1, state.tsu),
    )


def _associate(state: TrackerState, dets: Detections, params: TrackerParams):
    """Two-stage association. Returns (match (T,) det idx or -1,
    det_unmatched (N,) bool). Both stages always run: with no eligible row
    or column they match nothing, which is what JAX's skipped stage gives
    (a detection without a feature costs INFTY in the cascade)."""
    confirmed = state.active & (state.state == CONFIRMED)

    # --- Stage 1: gated appearance cascade over confirmed tracks ----------
    meas_xyah = tlwh_to_xyah(dets.tlwh)
    gal_idx = torch.arange(state.gallery.shape[1], device=state.mean.device)
    gallery_valid = gal_idx[None, :] < state.gallery_count[:, None]
    app_cost = appearance_cost_matrix(
        state.gallery, gallery_valid, dets.feature, dets.has_feature)
    gate = kalman.gating_distance(state.mean, state.cov, meas_xyah)
    app_cost = torch.where(gate > kalman.CHI2INV95[4],
                           torch.full_like(app_cost, INFTY_COST), app_cost)
    cascade_match, det_unmatched = matching_cascade(
        app_cost, state.tsu, confirmed, dets.valid,
        params.max_cosine_distance, params.max_age)

    # --- Stage 2: IoU matching ----------------------------------------------
    tentative = state.active & (state.state == TENTATIVE)
    recently_missed = confirmed & (cascade_match < 0) & (state.tsu == 1)
    iou_rows = tentative | recently_missed
    iou_cost = iou_cost_matrix(mean_to_tlwh(state.mean), dets.tlwh)
    iou_match = min_cost_matching(iou_cost, iou_rows, det_unmatched,
                                  params.max_iou_distance)

    match = torch.where(cascade_match >= 0, cascade_match, iou_match)
    return match, _claim(iou_match, det_unmatched)


def update(state: TrackerState, dets: Detections,
           params: TrackerParams) -> TrackerState:
    """Measurement update + track management for one frame (after
    :func:`predict`)."""
    t = params.max_tracks
    g = params.nn_budget
    dev = state.mean.device
    rows = torch.arange(t, device=dev)

    match, det_unmatched = _associate(state, dets, params)
    matched = match >= 0
    det_idx = torch.clamp(match, min=0)

    # --- Matched tracks: KF correction + attribute updates ------------------
    # (every slot is computed; unmatched ones keep their values)
    meas_xyah = tlwh_to_xyah(dets.tlwh)[det_idx]
    nsa_conf = dets.conf[det_idx] if params.nsa else None
    up_mean, up_cov = kalman.update(state.mean, state.cov, meas_xyah,
                                    confidence=nsa_conf)
    mean = torch.where(matched[:, None], up_mean, state.mean)
    cov = torch.where(matched[:, None, None], up_cov, state.cov)

    add_feat = matched & dets.has_feature[det_idx]
    new_feats = dets.feature[det_idx]                  # (T, D)
    if params.ema_alpha > 0.0:
        # EMA appearance bank in gallery slot 0:
        # e = normalize(a*e + (1-a)*normalize(f)); the first feature
        # (count == 0) initialises the bank directly.
        # 1 - a in f32, as in JAX; a fill on the device, not a copy from
        # the host (which a CUDA graph cannot capture)
        a = torch.full((), params.ema_alpha, dtype=torch.float32,
                       device=dev)
        f_n = new_feats / torch.clamp(torch.linalg.vector_norm(
            new_feats, dim=-1, keepdim=True), min=1e-7)
        cur = state.gallery[:, 0]
        blend = a * cur + (1.0 - a) * f_n
        blend = blend / torch.clamp(torch.linalg.vector_norm(
            blend, dim=-1, keepdim=True), min=1e-7)
        ema = torch.where((state.gallery_count > 0)[:, None], blend, f_n)
        gallery = state.gallery.clone()
        gallery[:, 0] = torch.where(add_feat[:, None], ema, cur)
        gallery_count = torch.where(
            add_feat, torch.clamp(state.gallery_count, min=1),
            state.gallery_count)
        gallery_next = state.gallery_next
    else:
        # Gallery append (FIFO ring).
        pos = state.gallery_next.long()
        cur = state.gallery[rows, pos]
        gallery = state.gallery.clone()
        gallery[rows, pos] = torch.where(add_feat[:, None], new_feats,
                                         cur)
        gallery_count = torch.where(
            add_feat, torch.clamp(state.gallery_count + 1, max=g),
            state.gallery_count)
        gallery_next = torch.where(add_feat, (state.gallery_next + 1) % g,
                                   state.gallery_next)

    hits = torch.where(matched, state.hits + 1, state.hits)
    tsu = torch.where(matched, torch.zeros_like(state.tsu), state.tsu)
    conf = torch.where(matched, dets.conf[det_idx], state.conf)
    class_id = torch.where(matched, dets.class_id[det_idx], state.class_id)
    st = torch.where(
        matched & (state.state == TENTATIVE) & (hits >= params.n_init),
        torch.full_like(state.state, CONFIRMED), state.state)

    # --- Unmatched tracks: mark_missed ---------------------------------------
    missed = state.active & ~matched
    delete = missed & ((state.state == TENTATIVE)
                       | ((state.state == CONFIRMED) & (tsu > params.max_age)))
    active = state.active & ~delete

    # --- Unmatched detections: initiate new tracks ---------------------------
    # (with none, every scatter drops everything and n_new, dropped are 0)
    new_det = det_unmatched & dets.valid
    slot_for_det, det_rank, n_new, dropped = place_new_tracks(
        active, new_det)

    init_mean, init_cov = kalman.initiate(tlwh_to_xyah(dets.tlwh))
    new_ids = state.next_id + det_rank

    def scatter(arr, values):
        return _scatter_drop(arr, slot_for_det, values)

    active = scatter(active, torch.ones_like(new_det))
    st = scatter(st, torch.full_like(det_rank, TENTATIVE))
    mean = scatter(mean, init_mean)
    cov = scatter(cov, init_cov)
    hits = scatter(hits, torch.ones_like(det_rank))
    age = scatter(state.age, torch.ones_like(det_rank))
    tsu = scatter(tsu, torch.zeros_like(det_rank))
    track_id = scatter(state.track_id, new_ids)
    class_id = scatter(class_id, dets.class_id)
    conf = scatter(conf, dets.conf)

    # Seed gallery slot 0 with the initiating detection's feature; data
    # beyond gallery_count is dead (every reader masks by count).
    seed = dets.has_feature
    seed_feat = dets.feature
    if params.ema_alpha > 0.0:
        seed_feat = seed_feat / torch.clamp(torch.linalg.vector_norm(
            seed_feat, dim=-1, keepdim=True), min=1e-7)
    seed_rows = torch.where(seed[:, None], seed_feat,
                            torch.zeros_like(seed_feat))
    # ``gallery`` is this step's own copy (made above): written in place
    gallery[:, 0] = _scatter_drop(gallery[:, 0], slot_for_det, seed_rows)
    gallery_count = scatter(gallery_count, seed.to(torch.int32))
    gallery_next = scatter(gallery_next, seed.to(torch.int32) % g)

    return state.replace(
        active=active, state=st, mean=mean, cov=cov,
        hits=hits, age=age, tsu=tsu,
        track_id=track_id, class_id=class_id, conf=conf,
        gallery=gallery, gallery_count=gallery_count,
        gallery_next=gallery_next,
        next_id=state.next_id + n_new,
        dropped=state.dropped + dropped,
    )


def get_outputs(state: TrackerState):
    """Confirmed tracks updated this frame, as (tlbr, id, class, conf, mask);
    masked lanes are zeros."""
    tlwh = mean_to_tlwh(state.mean)
    tlwh = torch.cat([tlwh[:, :2], torch.clamp(tlwh[:, 2:], min=0.0)], dim=1)
    tlbr = tlwh_to_tlbr(tlwh)
    z = state.active & (state.state == CONFIRMED) & (state.tsu == 0)
    return (torch.where(z[:, None], tlbr, torch.zeros_like(tlbr)),
            torch.where(z, state.track_id, torch.zeros_like(state.track_id)),
            torch.where(z, state.class_id, torch.zeros_like(state.class_id)),
            torch.where(z, state.conf, torch.zeros_like(state.conf)),
            z)
